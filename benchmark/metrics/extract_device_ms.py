"""pyramid, detection, orientation, descriptors: device milliseconds a
frame of the operations launched inside the program's `sift.extract`
spans (the union of their busy intervals, profiled work) over the
`sift.frames` counter of that work; None where no device operation ran."""


def read(data: dict):
    from benchmark.spans import per_frame

    if not data.get("device_ops"):
        return None
    return per_frame(data.get("span_device_ms", {}).get("sift.extract"),
                     data.get("profiled_counts", {}).get("sift.frames"))
