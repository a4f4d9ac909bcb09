"""SLAM driver: mean host milliseconds to enqueue a keyframe event's step
(`slam.event.dispatch` spans), recorded without the profiler, over the
`slam.events` counter: the event's dispatch apart from its device time,
fetch and apply, which `event_ms` sums."""


def read(data: dict):
    from benchmark.spans import per_frame

    return per_frame(data.get("span_host_ms", {}).get("slam.event.dispatch"),
                     data.get("counts", {}).get("slam.events"))
