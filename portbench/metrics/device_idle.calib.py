"""device_idle.calib (%, device trace): the share of the traced slice in which
no operation ran on the device.  Layer: device; moves calib_ms."""


def read(run):
    return run.idle_share()
