"""Port parity: the compact L-BFGS direction, plain and fused-kernel paths.

The same seeded numpy history goes through the JAX package's
`compact_direction` and `compact_direction_pallas` (Pallas interpret mode
on the CPU, as tests/test_ops.py runs it) and through the port's
`compact_direction` and the CPU path of `compact_direction_cuda`.
Tolerance: relative 1e-5 of the largest direction entry, float32 on both
sides with different summation orders (the bound the JAX package holds
its own two backends to).

On CPU tensors `compact_direction_cuda` takes the kernels' plain PyTorch
versions and launches nothing; the CUDA kernels themselves are compared
with those plain versions on the card by `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.ops import compact_direction_pallas as j_pallas
from federated_pytorch_test_tpu.optim.compact import compact_direction as j_compact
from federated_pytorch_test_tpu_torch.ops import compact_cuda
from federated_pytorch_test_tpu_torch.optim import compact_direction


def _history(m, n, seed):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(m, n)).astype(np.float32) * 0.1
    d = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    y = (s * d + 0.01 * rng.normal(size=(m, n))).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    return s, y, g


def _close(a, b, rtol=1e-5):
    scale = np.max(np.abs(b)) + 1e-30
    np.testing.assert_allclose(np.asarray(a) / scale, np.asarray(b) / scale, atol=rtol)


def _port(fn, g, s, y, count, h_diag):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out = fn(
        t(g), t(s), t(y),
        torch.as_tensor(count, dtype=torch.int32),
        torch.as_tensor(h_diag, dtype=torch.float32),
    )
    return out.numpy()


@pytest.mark.parametrize("count", [0, 1, 4, 10])
def test_direction_matches_jax(count):
    m, n = 10, 3000
    s, y, g = _history(m, n, count)
    # an invalid (row >= count) slot full of NaN must not leak in
    if count < m:
        s[count] = np.nan
        y[count] = np.nan
    args = (jnp.asarray(g), jnp.asarray(s), jnp.asarray(y), jnp.int32(count), jnp.float32(0.7))
    ref = np.asarray(j_compact(*args))
    ref_pallas = np.asarray(j_pallas(*args))
    compact_cuda.reset_launch_counts()
    for fn in (compact_direction, compact_cuda.compact_direction_cuda):
        out = _port(fn, g[None], s[None], y[None], [count], [0.7])[0]
        assert np.all(np.isfinite(out))
        _close(out, ref)
        _close(out, ref_pallas)
    # CPU tensors take the plain versions: no kernel launched
    assert compact_cuda.LAUNCHES == {"fused_gram_projections": 0, "fused_direction_assembly": 0}


def test_degenerate_slot_matches_jax():
    # a zero-curvature slot (y_i . s_i == 0) contributes nothing
    m, n = 8, 2000
    s, y, g = _history(m, n, 2)
    y[3] = 0.0
    args = (jnp.asarray(g), jnp.asarray(s), jnp.asarray(y), jnp.int32(m), jnp.float32(1.0))
    ref = np.asarray(j_pallas(*args))
    for fn in (compact_direction, compact_cuda.compact_direction_cuda):
        _close(_port(fn, g[None], s[None], y[None], [m], [1.0])[0], ref)


def test_batched_clients_match_jax_vmap():
    k, m, n = 4, 6, 2500
    parts = [_history(m, n, 10 + i) for i in range(k)]
    s = np.stack([p[0] for p in parts])
    y = np.stack([p[1] for p in parts])
    g = np.stack([p[2] for p in parts])
    counts = np.asarray([0, 2, 5, 6], np.int32)
    hd = np.asarray([1.0, 0.5, 2.0, 0.9], np.float32)
    ref = np.asarray(
        jax.vmap(j_pallas)(jnp.asarray(g), jnp.asarray(s), jnp.asarray(y), jnp.asarray(counts), jnp.asarray(hd))
    )
    for fn in (compact_direction, compact_cuda.compact_direction_cuda):
        _close(_port(fn, g, s, y, counts, hd), ref)


def test_fused_gram_projections_plain_matches_jax():
    from federated_pytorch_test_tpu.ops import fused_gram_projections as j_gram

    m, n = 10, 5000
    s, y, g = _history(m, n, 0)
    ref = j_gram(jnp.asarray(s), jnp.asarray(y), jnp.asarray(g), 7)
    out = compact_cuda.fused_gram_projections(
        torch.from_numpy(s[None]), torch.from_numpy(y[None]), torch.from_numpy(g[None]),
        torch.tensor([7], dtype=torch.int32),
    )
    for a, b in zip(out, ref):
        _close(a[0].numpy(), np.asarray(b))


def test_wrapper_rejects_mixed_devices():
    s = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        compact_cuda._on_cpu(s, torch.empty(0, device="meta"))


@pytest.mark.parametrize("n", [1, 255, 256, 456, 48_120, 32_768, 32_769, 4_720_644])
def test_gram_chunks_cover_the_columns_once(n):
    # the one-launch gram's grid: at most 44 blocks a client, an equal run
    # of 256-column tiles a block, every block with a tile (the launcher
    # refuses anything else)
    chunks, per_block = compact_cuda.gram_chunks(n)
    tiles = -(-n // 256)
    assert 1 <= chunks <= 44 and (chunks - 1) * per_block < tiles <= chunks * per_block
