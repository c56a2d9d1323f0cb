"""Share of rank 0's traced window in which no operation ran on its
card: 100 x (1 - the union of the device's operation intervals / the
window).  A collective's kernel that waits for another rank counts as
busy."""


def read(run):
    p = run.profile
    if p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
