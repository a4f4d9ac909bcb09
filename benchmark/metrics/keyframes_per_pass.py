"""SLAM driver: keyframe events of a pass (the program's applied
`on_event`s), the same in every pass when passes do the same work."""


def read(data: dict):
    kf = data.get("keyframes_per_pass") or []
    if not kf:
        return None
    return sum(kf) / len(kf)
