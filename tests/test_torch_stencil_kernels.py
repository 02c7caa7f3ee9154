"""The port's stencil kernels (repro_torch.kernels.stencil) against the
JAX package's Pallas kernels and their references.

On the CPU the wrappers run their plain PyTorch versions (no kernel
exists there), so these tests hold the plain versions — the arithmetic
the CUDA kernels are compared with on the card — to the reference, and
check the wrappers' input validation.  Inputs are made with numpy from
a seed and handed to both packages."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import stencil as ks

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.stencil import jacobi_sweep, jacobi_sweep_ref, stencil5_block  # noqa: E402


def _blocks(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(5)]


@pytest.mark.parametrize("shape", [(64, 64), (37, 100), (1, 17)])
def test_stencil5_plain_equals_pallas_f32(shape):
    """float32: bit-equal (torch.equal) to the Pallas kernel in interpret
    mode — both accumulate left-nested in f32 and scale by f32(0.2)."""
    xs = _blocks(shape, np.float32, 0)
    want = np.array(stencil5_block(*[jnp.asarray(x) for x in xs],
                                   weight=0.2, interpret=True))
    got = ks.stencil5_block(*[torch.from_numpy(x) for x in xs], weight=0.2)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.from_numpy(want))


@pytest.mark.parametrize("shape", [(64, 64), (37, 100)])
def test_stencil5_plain_equals_numpy_f64(shape):
    """float64: exact against NumPy's left-nested sum (the interpreter's
    arithmetic) — the Pallas kernel's f32 accumulation is not copied."""
    xs = _blocks(shape, np.float64, 1)
    want = 0.2 * ((((xs[0] + xs[1]) + xs[2]) + xs[3]) + xs[4])
    got = ks.stencil5_block(*[torch.from_numpy(x) for x in xs], weight=0.2)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)


def test_stencil5_strided_views_and_no_launch_on_cpu():
    """Strided slices are taken as they are; the CPU route is the plain
    version and counts no kernel launch."""
    big = _blocks((40, 50), np.float64, 2)
    views = [torch.from_numpy(b)[1:-1:2, 3:-2] for b in big]
    ks.reset_launches()
    got = ks.stencil5_block(*views, weight=0.25)
    want = ks.stencil5_block_plain(*[v.contiguous() for v in views], weight=0.25)
    assert torch.equal(got, want)
    assert ks.launches == {"stencil5_block": 0, "jacobi_sweep": 0}


@pytest.mark.parametrize("bad", ["dtype", "ndim", "shape"])
def test_stencil5_rejects_what_the_kernel_does_not_take(bad):
    xs = [torch.zeros(4, 4, dtype=torch.float64) for _ in range(5)]
    if bad == "dtype":
        xs[2] = torch.zeros(4, 4, dtype=torch.int64)
    elif bad == "ndim":
        xs[1] = torch.zeros(4, 4, 1, dtype=torch.float64)
    else:
        xs[4] = torch.zeros(4, 5, dtype=torch.float64)
    with pytest.raises((TypeError, ValueError)):
        ks.stencil5_block(*xs, weight=0.2)


@pytest.mark.parametrize("H,W,band", [
    (128, 256, 32), (100, 64, 32), (64, 64, 64), (96, 128, 128),
])
def test_jacobi_sweep_plain_matches_pallas(H, W, band):
    """The shapes of tests/test_kernels.py (ragged H=100 included),
    tolerance 1e-6 (float32), as there."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(4), (H, W)))
    want = np.asarray(jacobi_sweep(jnp.asarray(x), band=band))
    ref = np.asarray(jacobi_sweep_ref(jnp.asarray(x)))
    got = ks.jacobi_sweep(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 1e-6
    assert np.abs(got - ref).max() < 1e-6


def test_jacobi_sweep_iterated():
    x = np.array(jax.random.normal(jax.random.PRNGKey(5), (96, 96)))
    a = jnp.asarray(x)
    b = torch.from_numpy(x)
    for _ in range(4):
        a = jacobi_sweep(a, band=32)
        b = ks.jacobi_sweep(b)
    assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-6


def test_jacobi_sweep_f64_equals_numpy_five_views():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((50, 33))
    want = x.copy()
    want[1:-1, 1:-1] = 0.2 * (x[1:-1, 1:-1] + x[0:-2, 1:-1] + x[2:, 1:-1]
                              + x[1:-1, 0:-2] + x[1:-1, 2:])
    got = ks.jacobi_sweep(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


def test_jacobi_sweep_rejects_non_contiguous():
    x = torch.zeros(8, 8, dtype=torch.float64)
    with pytest.raises(ValueError):
        ks.jacobi_sweep(x.T[:, ::2])
    with pytest.raises(TypeError):
        ks.jacobi_sweep(torch.zeros(8, 8, dtype=torch.int32))


# ---------------------------------------------------------------------------
# stencil5_group: a table of fragments in one launch, written in place
# ---------------------------------------------------------------------------

from repro_torch.kernels.stencil import ops as kops  # noqa: E402

# (rows, cols) of the mixed group: a corner, halo slivers and a fragment
GROUP_SHAPES = [(1, 1), (1, 37), (29, 1), (30, 41), (1, 1), (12, 3)]


def _mixed_group(dtype, seed):
    """Fragments of GROUP_SHAPES: strided operands (column stride 2) and
    outputs that are strided slices of zeroed blocks."""
    rng = np.random.default_rng(seed)
    frags, outs = [], []
    for rows, cols in GROUP_SHAPES:
        xs = tuple(torch.from_numpy(rng.standard_normal((rows + 2, 2 * cols + 3)).astype(dtype))
                   [1:rows + 1, 1:2 * cols + 1:2] for _ in range(5))
        blk = torch.zeros(rows + 3, 3 * cols + 4, dtype=xs[0].dtype)
        out = blk[2:rows + 2, 1:3 * cols + 1:3]
        frags.append((xs, out))
        outs.append(blk)
    return frags, outs


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stencil5_group_plain_equals_blocks_and_numpy(dtype):
    """Every fragment's output view holds stencil5_block_plain of its
    operands, which is NumPy's left-nested sum bit for bit; the rest of
    each output block is untouched; no launch is counted on the CPU."""
    frags, blocks = _mixed_group(dtype, 11)
    ks.reset_launches()
    ks.stencil5_group(frags, weight=0.2)
    assert ks.launches["stencil5_block"] == 0 and not ks.fragment_shapes
    w = dtype(0.2)
    for (xs, out), blk in zip(frags, blocks):
        a = [x.numpy() for x in xs]
        want = w * ((((a[0] + a[1]) + a[2]) + a[3]) + a[4])
        assert torch.equal(out, ks.stencil5_block_plain(*xs, weight=0.2))
        assert np.array_equal(out.numpy(), want)
        assert int((blk != 0).sum()) <= out.numel()


def test_stencil5_group_aliased_output_is_staged():
    """An output that overlaps one of its own operands is detected (the
    kernel route stages it through a temporary); the result is the
    per-fragment result, computed before any of it is written.  Disjoint
    views of one block are not taken for overlapping."""
    rng = np.random.default_rng(12)
    blk = torch.from_numpy(rng.standard_normal((20, 30)))
    xs = (blk[1:-1, 1:-1], blk[:-2, 1:-1], blk[2:, 1:-1], blk[1:-1, :-2], blk[1:-1, 2:])
    want = ks.stencil5_block_plain(*xs, weight=0.2)
    out = blk[1:-1, 1:-1]
    assert kops._overlaps(out, xs[1]) and kops._overlaps(out, xs[0])
    assert not kops._overlaps(blk[0:1, :5], blk[1:2, :5])  # rows apart
    assert not kops._overlaps(blk[:5, 0:3], blk[:5, 3:6])  # columns apart
    assert not kops._overlaps(blk[:5, :5], torch.zeros(5, 5, dtype=blk.dtype))
    ks.stencil5_group([(xs, out)], weight=0.2)
    assert torch.equal(out, want)


def test_stencil5_group_shared_route_detection():
    """The host picks the kernel's shared-memory route only for five
    shifts of one storage by 0 and +-1 row or column (unit column
    stride), in any operand order, with 16-byte pieces when the row
    stride keeps 16-byte phase; slivers across blocks take the generic
    loads."""
    blk = torch.zeros(66, 66, dtype=torch.float64)
    plus = [blk[1:-1, 1:-1], blk[:-2, 1:-1], blk[2:, 1:-1], blk[1:-1, :-2], blk[1:-1, 2:]]
    mode, centre = kops._shared_route(plus)
    assert mode & 3 == 3 and centre == blk[1:-1, 1:-1].data_ptr()
    assert [(mode >> (4 + 3 * i)) & 7 for i in range(5)] == [0, 1, 2, 3, 4]
    mode, _ = kops._shared_route(plus[::-1])
    assert [(mode >> (4 + 3 * i)) & 7 for i in range(5)] == [4, 3, 2, 1, 0]
    odd = torch.zeros(9, 65, dtype=torch.float64)  # 65 * 8 bytes: phase changes by row
    mode, _ = kops._shared_route([odd[1:-1, 1:-1], odd[:-2, 1:-1], odd[2:, 1:-1],
                                  odd[1:-1, :-2], odd[1:-1, 2:]])
    assert mode & 3 == 1
    other = torch.zeros(66, 66, dtype=torch.float64)
    assert kops._shared_route(plus[:4] + [other[1:-1, 2:]]) == (0, 0)
    assert kops._shared_route(plus[:4] + [blk[1:-1, 1:-1]]) == (0, 0)  # a repeat
    assert kops._shared_route([x[:, ::2] for x in plus]) == (0, 0)
    row = kops._table(plus, blk[1:-1, 1:-1])
    assert len(row) == kops._FIELDS and row[-1] & 1 and row[1:5] == [0, 0, 0, 0]


@pytest.mark.parametrize("bad", ["operands", "dtype", "shape"])
def test_stencil5_group_rejects_what_the_kernel_does_not_take(bad):
    xs = tuple(torch.zeros(4, 4, dtype=torch.float64) for _ in range(5))
    out = torch.zeros(4, 4, dtype=torch.float64)
    frags = [(xs, out), (xs, torch.zeros(4, 4, dtype=torch.float64))]
    if bad == "operands":
        frags[1] = (xs[:4], frags[1][1])
    elif bad == "dtype":
        frags[1] = (tuple(x.float() for x in xs), frags[1][1].float())
    else:
        frags[1] = (xs, torch.zeros(4, 5, dtype=torch.float64))
    with pytest.raises(ValueError):
        ks.stencil5_group(frags, weight=0.2)
