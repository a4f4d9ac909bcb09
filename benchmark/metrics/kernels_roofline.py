"""kernels layer: the least time the traced work needs on the card
(`benchmark/work/`, from the cell's shapes) over the card's busy time in
the traced window, in percent."""


def read(data: dict):
    from benchmark.work import least_time_s

    if data["busy_s"] <= 0:
        return None
    return 100.0 * least_time_s(data["work"]) / data["busy_s"]
