"""ops layer (host dispatch): device operations (kernels, copies, fills)
in the traced window over the frames it served."""


def read(data: dict):
    if data["device_ops"] == 0 or data["frames"] == 0:
        return None
    return data["device_ops"] / data["frames"]
