"""Sorted-window matmul scatter-add (ops/scatter.py) vs numpy add.at."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsdf_tpu.ops.scatter import (
    scatter_add_flat,
    scatter_set_int,
    take_flat,
)


def _ref(n, lin, val):
    out = np.zeros(n, np.float32)
    ok = (lin >= 0) & (lin < n)
    np.testing.assert_array_equal  # noqa: B018 (keep import obvious)
    np.add.at(out, lin[ok], val[ok])
    return out


@pytest.mark.parametrize("n", [100, 128, 1000, 70000])
@pytest.mark.parametrize("c", [0, 1, 37, 5000])
def test_scatter_add_random(n, c):
    rng = np.random.RandomState(n + c)
    lin = rng.randint(-5, n + 5, size=c).astype(np.int32)
    val = rng.randn(c).astype(np.float32)
    out = np.asarray(
        scatter_add_flat(n, jnp.asarray(lin), jnp.asarray(val),
                         window=64, rows_per_patch=16)
    )
    np.testing.assert_allclose(out, _ref(n, lin, val), rtol=1e-6, atol=1e-5)


def test_scatter_add_heavy_duplicates():
    n = 512
    rng = np.random.RandomState(0)
    lin = rng.randint(0, 4, size=10000).astype(np.int32)  # 4 hot targets
    val = rng.rand(10000).astype(np.float32)
    out = np.asarray(scatter_add_flat(n, jnp.asarray(lin), jnp.asarray(val)))
    np.testing.assert_allclose(out, _ref(n, lin, val), rtol=1e-5, atol=1e-2)


def test_scatter_add_sparse_span():
    # contributions separated by far more than rows_per_patch rows: the
    # cursor must still make progress (prefix consumption)
    n = 1 << 20
    lin = np.array([0, 131072, 262144, 524288, n - 1], np.int32)
    val = np.ones(5, np.float32)
    out = scatter_add_flat(
        n, jnp.asarray(lin), jnp.asarray(val), window=64, rows_per_patch=8
    )
    got = np.asarray(out)
    np.testing.assert_allclose(got[lin], 1.0)
    assert float(got.sum()) == 5.0


def test_scatter_add_multi_payload_sorted():
    n = 300
    lin = np.sort(np.random.RandomState(1).randint(0, n, 400)).astype(
        np.int32
    )
    vals = np.random.RandomState(2).randn(3, 400).astype(np.float32)
    out = np.asarray(
        scatter_add_flat(
            n, jnp.asarray(lin), jnp.asarray(vals), is_sorted=True,
            window=32, rows_per_patch=8,
        )
    )
    for d in range(3):
        np.testing.assert_allclose(
            out[d], _ref(n, lin, vals[d]), rtol=1e-6, atol=1e-5
        )


def test_scatter_add_32_channels_unsorted():
    # the deform update's shape: 32 payload channels through ONE fused
    # matmul + patch update per window
    n, c = 4096, 2000
    rng = np.random.RandomState(7)
    lin = rng.randint(-3, n + 3, size=c).astype(np.int32)
    vals = rng.randn(32, c).astype(np.float32)
    out = np.asarray(
        scatter_add_flat(
            n, jnp.asarray(lin), jnp.asarray(vals),
            window=128, rows_per_patch=16,
        )
    )
    assert out.shape == (32, n)
    for d in range(32):
        np.testing.assert_allclose(
            out[d], _ref(n, lin, vals[d]), rtol=1e-6, atol=1e-4
        )


def test_scatter_set_int_large_values():
    n = 1000
    rng = np.random.RandomState(3)
    lin = rng.permutation(n)[:200].astype(np.int32)  # unique targets
    val = rng.randint(0, 1 << 27, size=200).astype(np.int32)
    out = np.asarray(scatter_set_int(n, jnp.asarray(lin), jnp.asarray(val)))
    ref = np.zeros(n, np.int32)
    ref[lin] = val
    np.testing.assert_array_equal(out, ref)


def test_take_flat_forward_and_grad():
    n = 4096
    rng = np.random.RandomState(4)
    flat = jnp.asarray(rng.randn(n).astype(np.float32))
    lin = jnp.asarray(rng.randint(0, n, size=(7, 11)).astype(np.int32))
    ct = jnp.asarray(rng.randn(7, 11).astype(np.float32))

    np.testing.assert_array_equal(
        np.asarray(take_flat(flat, lin)),
        np.asarray(jnp.take(flat, lin, axis=0)),
    )

    g_new = jax.grad(lambda f: jnp.sum(take_flat(f, lin) * ct))(flat)
    g_ref = jax.grad(lambda f: jnp.sum(jnp.take(f, lin, axis=0) * ct))(flat)
    np.testing.assert_allclose(
        np.asarray(g_new), np.asarray(g_ref), rtol=1e-6, atol=1e-5
    )


def test_scatter_fold_offsets_matches_naive():
    """fold_offsets: G stencil taps sharing one window walk == G naive
    scatters at shifted targets (incl. out-of-range taps dropped and an
    offset spanning multiple 128-lane rows)."""
    import numpy as np

    from tsdf_tpu.ops.scatter import scatter_add_flat

    rng = np.random.default_rng(7)
    n = 5000
    C = 600
    offs = (0, 1, 130, 400)  # lane shift, row-crossing, multi-row
    lin = np.sort(rng.integers(0, n, size=C)).astype(np.int32)
    val = rng.normal(size=(4 * 2, C)).astype(np.float32)  # Dout=2

    got = scatter_add_flat(
        n, jnp.asarray(lin), jnp.asarray(val),
        is_sorted=True, fold_offsets=offs,
    )
    ref = np.zeros((2, n), np.float32)
    for g, off in enumerate(offs):
        for c in range(C):
            t = lin[c] + off
            if 0 <= t < n:
                ref[:, t] += val[2 * g : 2 * g + 2, c]
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-4)


def test_sorted_hint_with_leading_sentinels():
    """is_sorted=True with out-of-range sentinels anywhere in the stream
    must still drop ONLY the sentinels (the hint is verified and falls
    back to sorting when the remapped stream is not monotone)."""
    import jax.numpy as jnp
    import numpy as np

    from tsdf_tpu.ops.scatter import scatter_add_flat

    out = scatter_add_flat(
        10, jnp.array([-1, -1, 3, 7]), jnp.ones(4), is_sorted=True
    )
    expect = np.zeros(10)
    expect[3] = expect[7] = 1.0
    np.testing.assert_array_equal(np.asarray(out), expect)

    # interspersed invalids, multi-channel
    out2 = scatter_add_flat(
        6,
        jnp.array([0, -5, 2, 99, 2]),
        jnp.stack([jnp.ones(5), 2.0 * jnp.ones(5)]),
        is_sorted=True,
    )
    expect2 = np.zeros((2, 6))
    expect2[:, 0] = (1, 2)
    expect2[:, 2] = (2, 4)
    np.testing.assert_array_equal(np.asarray(out2), expect2)


def test_gather_flat_matches_take():
    """gather_flat == jnp.take across table widths, fill modes, and
    index streams incl. out-of-range, duplicates, and reverse order
    (the un-sort must restore the original stream order)."""
    from tsdf_tpu.ops.scatter import gather_flat

    rng = np.random.RandomState(11)
    for n, D, C in [(300, 1, 500), (70000, 4, 3000), (1000, 3, 1)]:
        tab = rng.randn(n, D).astype(np.float32)
        tab_in = tab[:, 0] if D == 1 else tab
        lin = rng.randint(-7, n + 7, size=C).astype(np.int32)
        for fill in ("clip", "zero"):
            got = np.asarray(
                gather_flat(
                    jnp.asarray(tab_in), jnp.asarray(lin),
                    window=64, rows_per_patch=8, fill_mode=fill,
                )
            )
            ref = tab[np.clip(lin, 0, n - 1)]
            if fill == "zero":
                ref = np.where(
                    ((lin < 0) | (lin >= n))[:, None], 0.0, ref
                )
            if D == 1:
                ref = ref[:, 0]
            np.testing.assert_array_equal(got, ref)


def test_gather_flat_dead_tail_and_sparse_span():
    """A stream that is mostly out-of-range sentinels (the SceneFusion
    dead-slot shape) and live indices separated by more than
    rows_per_patch rows (prefix consumption must still advance)."""
    from tsdf_tpu.ops.scatter import gather_flat

    n = 1 << 18
    tab = jnp.arange(n, dtype=jnp.float32)
    live = np.array([0, 4096, 65536, 131072, n - 1], np.int32)
    lin = np.full(4096, n, np.int32)  # dead sentinel
    lin[: len(live)] = live[::-1]  # live prefix, unsorted
    got = np.asarray(
        gather_flat(
            tab, jnp.asarray(lin),
            window=32, rows_per_patch=8, fill_mode="zero",
        )
    )
    np.testing.assert_array_equal(got[: len(live)], live[::-1])
    np.testing.assert_array_equal(got[len(live):], 0.0)


def test_gather_flat_rejects_bool_true_hint():
    """gather_flat has no checked-hint mode: is_sorted=True must raise
    (only False or the explicit 'trusted' contract are valid)."""
    import pytest

    from tsdf_tpu.ops.scatter import gather_flat

    tab = jnp.arange(10.0)
    idx = jnp.arange(4, dtype=jnp.int32)
    with pytest.raises(ValueError, match="trusted"):
        gather_flat(tab, idx, is_sorted=True)
