"""pyramid, detection, orientation, descriptors: host milliseconds a frame
inside the program's `sift.extract` spans, recorded without the profiler
(`cusift_tpu_torch.utils.trace.recording()`), over its `sift.frames`
counter (frames extracted, a chunk's padding frames included)."""


def read(data: dict):
    from benchmark.spans import per_frame

    return per_frame(data.get("span_host_ms", {}).get("sift.extract"),
                     data.get("counts", {}).get("sift.frames"))
