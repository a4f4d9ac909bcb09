"""device layer: the share of the traced window in which no kernel, copy
or fill ran on the card (`torch.profiler`'s device activity)."""


def read(data: dict):
    if data["window_s"] <= 0 or data["device_ops"] == 0:
        return None
    return 100.0 * (1.0 - data["busy_s"] / data["window_s"])
