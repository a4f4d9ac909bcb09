"""SLAM driver: host milliseconds a frame the main thread spends blocked in
the program's fetches (`fetch` spans: a step's packed result copied to the
host, which waits for the device), recorded without the profiler, over
the `slam.frames` counter (frames committed)."""


def read(data: dict):
    from benchmark.spans import per_frame

    return per_frame(data.get("span_host_ms", {}).get("fetch"),
                     data.get("counts", {}).get("slam.frames"))
