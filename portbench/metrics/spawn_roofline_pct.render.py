"""The spawn kernel's share of its roofline over the traced window: the
least time the window's spawn launches could take (portbench/roofline.py:
per level max(bytes / 3.35 TB/s, 54 x tests needed / 33.5 T/s), summed
over one pooled wavefront's three levels, times the window's wavefronts)
over the profile's `spawn_kernel` time.  The tests needed are counted
after the window on the rays of one wavefront drawn from the seed."""

from portbench.roofline import spawn_bound_s


def read(run):
    spawn = run.profile.device_s(r"\bspawn_kernel\b")
    if spawn <= 0:
        return None
    mix = run.session.mix
    bound = spawn_bound_s(run.port, run.session.rt, mix["pool"], run.seed)
    wavefronts = run.units * mix["spp"] // mix["pool"]
    return 100.0 * bound * wavefronts / spawn
