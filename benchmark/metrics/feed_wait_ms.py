"""SLAM driver (feeder): host milliseconds a frame the main thread waits
on the frame feeder's queue (`feed.wait` spans), recorded without the
profiler, over the `slam.frames` counter (frames committed)."""


def read(data: dict):
    from benchmark.spans import per_frame

    return per_frame(data.get("span_host_ms", {}).get("feed.wait"),
                     data.get("counts", {}).get("slam.frames"))
