"""The product draw source (core/engine.py `TorchDraws`): one stream per
sample, so a pooled render equals the unpooled one bit for bit, as the
reference holds its own (tests/test_fused_spawn.py:160-174), and
`split(n)` gives independent sources, one per rank of render_sharded."""

import numpy as np
import torch

import raytracer_tpu_torch as rtx
from raytracer_tpu_torch.core.engine import TorchDraws, TorchStream
from tests.test_torch_wavefront import torch_threads  # noqa: F401 (autouse)

W, H = 32, 16


def _render(data_dir, pool, spp):
    rt = rtx.create_raytracer_from_file(
        str(data_dir / "4boxes.dae"), width=W, height=H, recursions=1,
        seed=3, spp_pool=pool, device="cpu")
    assert rt.fused and rt._choose_pool(spp) == pool
    return rt.render(spp)


def test_pooled_engine_render_matches_unpooled(data_dir):
    """The default draws: render(2) with 2 samples in one wavefront
    equals two wavefronts of one sample, value for value."""
    pooled = _render(data_dir, 2, 2)
    assert np.isfinite(pooled).all() and pooled.max() > 0
    np.testing.assert_array_equal(pooled, _render(data_dir, 1, 2))


def test_render_does_not_depend_on_the_pool(data_dir):
    """render(4) at pools 4, 2 and 1: the same film, value for value."""
    films = [_render(data_dir, pool, 4) for pool in (4, 2, 1)]
    np.testing.assert_array_equal(films[0], films[1])
    np.testing.assert_array_equal(films[0], films[2])


def _sample(draws, n=64):
    jitter, stream = draws.next_sample(n)
    return jitter, stream.normal(0, n), stream.normal(1, 2 * n)


def test_split_sources_do_not_depend_on_each_others_use():
    """Each source of split(n) draws the same numbers whether or not
    its siblings drew before it, and the siblings differ."""
    alone = TorchDraws(5, "cpu").split(3)[2]
    ranks = TorchDraws(5, "cpu").split(3)
    for _ in range(3):
        _sample(ranks[0])
        _sample(ranks[1], n=17)
    for a, b in zip(_sample(alone), _sample(ranks[2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    first = [_sample(d)[0] for d in TorchDraws(5, "cpu").split(3)]
    assert not torch.equal(first[0], first[1])
    assert not torch.equal(first[1], first[2])
    # the split advances the parent: the next frame's sources are new
    parent = TorchDraws(5, "cpu")
    a, b = parent.split(2), parent.split(2)
    assert not torch.equal(_sample(a[0])[0], _sample(b[0])[0])


def test_sample_stream_does_not_depend_on_draw_order():
    """A sample's jitter and each level's Gaussians come from generators
    of their own: asking for the levels in another order, or for the
    jitter last, changes nothing."""
    a, b = TorchStream(9, "cpu"), TorchStream(9, "cpu")
    ga0, ga1, ja = a.normal(0, 10), a.normal(1, 20), a.jitter(10)
    jb, gb1, gb0 = b.jitter(10), b.normal(1, 20), b.normal(0, 10)
    for x, y in ((ga0, gb0), (ga1, gb1), (ja, jb)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert ja.shape == (10, 2) and ((ja >= 0) & (ja < 1)).all()
    assert not torch.equal(ga0, ga1[:10])

