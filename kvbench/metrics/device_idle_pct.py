"""Share of the profiled slice in which no operation ran on the device
(1 - the union of the device operations' intervals / the slice), in
percent."""


def read(run):
    p = run.profile
    if p is None or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_s / (p.t1 - p.t0))
