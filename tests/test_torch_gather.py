"""The row gather of the differentiable shading (ops/cuda_gather.py):
its forward is `table[idx]` bit for bit, its plain backward autograd's
gradient of `table[idx]`, and the shading's gathers run its backward
only when autograd needs it.  The tests marked `cuda` hold the kernel
against the plain version on the card and skip without one.

This file imports neither JAX nor the reference package, so it runs on
a machine without them; the repo's conftest imports JAX, hence on the
card:

    python -m pytest --noconftest -q tests/test_torch_gather.py
"""

from types import SimpleNamespace

import pytest
import torch

from raytracer_tpu_torch.core import shade
from raytracer_tpu_torch.ops import cuda_gather
from raytracer_tpu_torch.ops.cuda_gather import (gather_rows,
                                                 rows_backward,
                                                 rows_backward_plain,
                                                 sum_depth)
from raytracer_tpu_torch.utils import profiling

# the tables of the differentiable shading: the triangles' vertices of
# ico3_tex (608 x 3 x 3), its diffuse colours (5 geometries), one row
SHAPES = [(608, 3, 3), (5, 3), (1, 3)]


def _indices(n, m, kind, gen):
    """m indices into n rows: "hot" sends 90 % to row 0, "every" covers
    every row, "empty" is none."""
    if kind == "empty":
        return torch.zeros((0,), dtype=torch.int64)
    idx = torch.randint(0, n, (m,), generator=gen)
    if kind == "hot":
        idx[torch.rand((m,), generator=gen) < 0.9] = 0
    else:
        idx[:n] = torch.randperm(n, generator=gen)
    return idx


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_is_indexing_bit_for_bit(shape):
    gen = torch.Generator().manual_seed(1)
    table = torch.randn(shape, generator=gen)
    idx = _indices(shape[0], 3000, "hot", gen)
    got = gather_rows(table.requires_grad_(True), idx)
    assert torch.equal(got.detach().view(torch.int32),
                       table.detach()[idx].view(torch.int32))


U = 2.0 ** -24      # float32's unit roundoff


@pytest.mark.parametrize("kind", ["hot", "empty", "every"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_is_autograds_gradient(shape, kind):
    """The plain version adds each row's values in index order, bit for
    bit; autograd's backward of `table[idx]` on the CPU sums the same
    values in an order of its own for a larger table, so the two agree
    within twice the worst case of a float32 sum of a row's k values in
    any order ((k - 1) x 2^-24 x their sum of |values|, Higham)."""
    gen = torch.Generator().manual_seed(2)
    table = torch.randn(shape, generator=gen)
    idx = _indices(shape[0], 4000, kind, gen)
    w = torch.randn((idx.shape[0], *shape[1:]), generator=gen)
    grads = []
    for gather in (gather_rows, lambda t, i: t[i]):
        leaf = table.clone().requires_grad_(True)
        (gather(leaf, idx) * w).sum().backward()
        grads.append(leaf.grad)
    serial = torch.zeros_like(table)
    for i, row in enumerate(idx.tolist()):
        serial[row] += w[i]
    assert torch.equal(grads[0], serial)
    k = torch.bincount(idx, minlength=shape[0]).reshape(
        (-1,) + (1,) * (len(shape) - 1))
    scale = torch.zeros_like(table).index_add_(0, idx, w.abs())
    assert ((grads[0] - grads[1]).abs() <= 2 * k * U * scale).all()
    if kind == "every":
        assert (grads[0] != 0).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_takes_a_strided_gradient(shape):
    """Autograd may hand the backward a gradient that is not contiguous:
    here y is used transposed, so its gradient is a transposed view.  It
    is read as rows all the same: the plain version's gradient equals
    indexing's, each row's sum within the bound of the test above."""
    gen = torch.Generator().manual_seed(7)
    table = torch.randn(shape, generator=gen)
    idx = _indices(shape[0], 500, "hot", gen)
    w = torch.randn((500, *shape[1:]), generator=gen).transpose(
        0, -1).contiguous()                 # the shape of y transposed
    seen, backward = [], cuda_gather._GatherRows.backward

    def spy(ctx, grad):
        seen.append(grad.is_contiguous())
        return backward(ctx, grad)
    grads = []
    for gather in (gather_rows, lambda t, i: t[i]):
        leaf = table.clone().requires_grad_(True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cuda_gather._GatherRows, "backward",
                       staticmethod(spy))
            (gather(leaf, idx).transpose(0, -1) * w).sum().backward()
        grads.append(leaf.grad)
    assert seen == [False]
    k = torch.bincount(idx, minlength=shape[0]).reshape(
        (-1,) + (1,) * (len(shape) - 1))
    scale = torch.zeros_like(table).index_add_(
        0, idx, w.transpose(0, -1).abs())
    assert ((grads[0] - grads[1]).abs() <= 2 * k * U * scale).all()


def test_sum_depth_bounds_each_row_by_its_own_entries():
    """A row of k entries is summed at most 5 + k deep, and never deeper
    than the warps of the call allow, however many entries it has."""
    m = 2 ** 21
    k = torch.tensor([0, 1, 50, 2 ** 20])
    assert sum_depth(k, m).tolist() == [5, 6, 55, 5 + m // 32]
    assert sum_depth(k, 33).tolist() == [5, 6, 7, 7]


def _scene(requires_grad):
    """Two geometries, the second textured by a 4 x 5 texture in a
    (1, 4, 5, 3) atlas, and three triangles."""
    gen = torch.Generator().manual_seed(3)
    return SimpleNamespace(
        tri_verts=torch.randn((3, 3, 3), generator=gen)
        .requires_grad_(requires_grad),
        tri_geom=torch.tensor([0, 1, 1], dtype=torch.int32),
        mat_diffuse_rgb=torch.rand((2, 3), generator=gen)
        .requires_grad_(requires_grad),
        mat_tex_id=torch.tensor([-1, 0], dtype=torch.int32),
        tex_atlas=torch.rand((1, 4, 5, 3), generator=gen)
        .requires_grad_(requires_grad),
        tex_hw=torch.tensor([[4, 5]], dtype=torch.int32))


def _shade_gathers(scene):
    gen = torch.Generator().manual_seed(4)
    tri = torch.randint(0, 3, (64,), generator=gen, dtype=torch.int32)
    u, v = torch.rand((2, 64), generator=gen)
    return (shade.geometric_normal(scene.tri_verts, tri).sum()
            + shade.sample_diffuse(scene, tri, u, v).sum()
            + shade.texel(scene, torch.zeros_like(tri), u, v).sum())


def _recording(monkeypatch):
    calls = []

    def record(table, idx):
        calls.append(tuple(table.shape))
        return gather_rows(table, idx)
    monkeypatch.setattr(shade, "gather_rows", record)
    return calls


def test_shading_gathers_bypass_gather_rows_without_grad():
    """Under no_grad, and for tables that do not require grad, autograd
    records no gather, so its backward never runs: no launch is
    counted."""
    before = profiling.counters()
    with torch.no_grad():
        assert not _shade_gathers(_scene(True)).requires_grad
    assert not _shade_gathers(_scene(False)).requires_grad
    key = "gather_rows.launches"
    assert profiling.counters()[key] == before[key]


def test_shading_gathers_take_gather_rows_under_grad(monkeypatch):
    """With grad on and the tables requiring it, each gather enters
    gather_rows (the atlas as (T * H * W, 3) rows of a flat texel index),
    and the gradients equal those of plain indexing bit for bit."""
    calls = _recording(monkeypatch)
    scene = _scene(True)
    leaves = [scene.tri_verts, scene.mat_diffuse_rgb, scene.tex_atlas]
    got = torch.autograd.grad(_shade_gathers(scene), leaves)
    assert sorted(calls) == sorted([(3, 3, 3), (2, 3), (20, 3), (20, 3)])
    monkeypatch.setattr(shade, "gather_rows", lambda t, i: t[i])
    want = torch.autograd.grad(_shade_gathers(scene), leaves)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_backward_checks_its_operands():
    with pytest.raises(ValueError):
        rows_backward(torch.zeros((4, 3)),
                      torch.zeros((5,), dtype=torch.int64), 2)
    with pytest.raises(ValueError):
        rows_backward(torch.zeros((4,)), torch.zeros((4,), dtype=torch.int64),
                      2)


# ---- on the card ---------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the inverse cell's shapes: its three levels' 1 + 2 + 2 M rays in one
# call (5.24 M rows), into ico3_tex's vertices and diffuse colours; and
# thai2's 20,049 triangles
CARD_CASES = [((608, 9), 5 * 2 ** 20, 0.5), ((5, 3), 5 * 2 ** 20, 0.9),
              ((20049, 9), 2 ** 21, 0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "x".join(
    map(str, c[0])))
def test_kernel_matches_the_plain_version(card, case):
    """Each row's error against the exact (float64) sum stays within the
    worst case of a float32 sum as deep as the kernel's sum of that row
    (`sum_depth` of the row's own entries x 2^-24 x the row's sum of
    |values|, Higham's bound for any order of additions: atomics add in
    an order that changes from run to run).
    On the hot row 0, whose plain sum walks millions of values one after
    another, the kernel's error is no larger than the plain version's."""
    (n, c), m, hot = case
    gen = torch.Generator().manual_seed(5)
    idx = torch.randint(0, n, (m,), generator=gen)
    idx[torch.rand((m,), generator=gen) < hot] = 0
    grad = torch.randn((m, c), generator=gen)
    key = "gather_rows.launches"
    before = profiling.counters()[key]
    got = rows_backward(grad.to(card), idx.to(card), n).cpu()
    assert profiling.counters()[key] == before + 1
    exact = rows_backward_plain(grad.double(), idx, n)
    plain = rows_backward_plain(grad, idx, n)
    scale = rows_backward_plain(grad.abs().double(), idx, n)
    bound = sum_depth(torch.bincount(idx, minlength=n), m)[:, None] * U * scale
    err = (got.double() - exact).abs()
    assert (err <= bound).all(), float((err / bound.clamp(min=1e-300)).max())
    assert float(err[0].max()) <= float((plain.double() - exact)[0]
                                        .abs().max())
    assert torch.isfinite(got).all()


@pytest.mark.cuda
def test_kernel_raises_on_operands_it_does_not_take(card):
    """Raises, and never falls back, on a strided, float64, int32 or
    CPU operand."""
    grad = torch.randn((64, 9), device=card)
    idx = torch.zeros((64,), dtype=torch.int64, device=card)
    for g, i in ((grad.t().contiguous().t(), idx), (grad.double(), idx),
                 (grad, idx.int()), (grad, idx.cpu()),
                 (grad[:, :3], idx)):
        with pytest.raises(ValueError):
            rows_backward(g, i, 608)


@pytest.mark.cuda
def test_gather_rows_gradient_on_the_card(card):
    """Through autograd, the card's gradient of a hot-row gather equals
    the CPU's to the kernel's depth bound, and the forward is bitwise."""
    gen = torch.Generator().manual_seed(6)
    table = torch.randn((608, 3, 3), generator=gen)
    idx = torch.randint(0, 608, (50000,), generator=gen)
    idx[:40000] = 0
    w = torch.randn((50000, 3, 3), generator=gen)
    out = {}
    for dev in ("cpu", card):
        leaf = table.to(dev).detach().requires_grad_(True)
        y = gather_rows(leaf, idx.to(dev))
        assert torch.equal(y.detach().cpu(), table[idx])
        (y * w.to(dev)).sum().backward()
        out[str(dev)] = leaf.grad.cpu()
    scale = rows_backward_plain(w.reshape(50000, 9).abs().double(), idx,
                                608).reshape(608, 3, 3)
    # each side within its own depth's bound of the exact sum; the CPU's
    # serial sum is at most as deep as the rows
    k = torch.bincount(idx, minlength=608)
    bound = (sum_depth(k, 50000) + k)[:, None, None] * U * scale
    assert ((out["cuda"].double() - out["cpu"].double()).abs()
            <= bound).all()
