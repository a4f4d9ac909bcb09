"""SLAM driver: mean host milliseconds of a keyframe event, from the
program's `on_event("dispatch")` to its `on_event("applied")` (the
event's enqueue, its device work, the fetch and any graph solve)."""


def read(data: dict):
    ev = data.get("event_ms") or []
    if not ev:
        return None
    return sum(ev) / len(ev)
