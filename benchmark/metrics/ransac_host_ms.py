"""match, RANSAC: host milliseconds a frame inside the program's
`ransac.homography` and `ransac.rigid` spans (recorded without the
profiler) over its `ransac.frames` counter (views or frames fitted)."""


def read(data: dict):
    from benchmark.spans import per_frame

    host = data.get("span_host_ms", {})
    return per_frame(host.get("ransac.homography", 0.0) + host.get("ransac.rigid", 0.0),
                     data.get("counts", {}).get("ransac.frames"))
