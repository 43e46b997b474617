"""Port kernels' plain versions vs the JAX oracles (and, at one aligned shape,
the Pallas kernels in interpret mode), fed the same numpy inputs.

On CPU tensors the kernel wrappers run their plain versions; the kernels
themselves are held against those on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention, fused_rmsnorm, ops, ref, reset_launch_counts  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # as tests/test_kernels.py
# one compile per shape instead of one per jnp op: keeps the sweep fast
_jax_attention = jax.jit(jref.attention, static_argnames=("causal", "window", "scale", "q_offset"))
_jax_rmsnorm = jax.jit(jref.rmsnorm, static_argnames=("eps", "gemma"))


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)


def both(arr, dtype):
    """The same numpy array as a jax array and a CPU torch tensor of ``dtype``."""
    return jnp.asarray(arr).astype(dtype), torch.from_numpy(arr).to(getattr(torch, dtype))


def to_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 64), (37, 960), (2, 5, 100), (3, 7)])
@pytest.mark.parametrize("gemma", [False, True])
def test_rmsnorm_matches_jax_oracle(shape, dtype, gemma):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.standard_normal(shape, dtype=np.float32), dtype)
    wj, wt = both(rng.standard_normal(shape[-1:], dtype=np.float32), dtype)
    got = ref.rmsnorm(xt, wt, gemma=gemma)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    exp = _jax_rmsnorm(xj, wj, gemma=gemma)
    assert rel_err(to_np(got), exp) < TOL[dtype]


ATTN_CASES = [
    # (B, Sq, Sk, Hq, Hkv, Dk, Dv, causal, window)
    (1, 1, 1, 3, 1, 64, 64, True, None),
    (2, 32, 32, 15, 5, 64, 64, True, None),
    (1, 37, 37, 4, 4, 32, 32, True, 8),      # ragged, windowed
    (2, 20, 45, 4, 2, 48, 24, False, None),  # Sq != Sk, Dk != Dv, not causal
    (1, 19, 19, 6, 2, 16, 16, False, 5),     # window without causality
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dk,Dv,causal,window", ATTN_CASES)
def test_attention_matches_jax_oracle(B, Sq, Sk, Hq, Hkv, Dk, Dv, causal, window, dtype):
    rng = np.random.default_rng(1)
    qj, qt = both(rng.standard_normal((B, Sq, Hq, Dk), dtype=np.float32), dtype)
    kj, kt = both(rng.standard_normal((B, Sk, Hkv, Dk), dtype=np.float32), dtype)
    vj, vt = both(rng.standard_normal((B, Sk, Hkv, Dv), dtype=np.float32), dtype)
    got = ref.attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == (B, Sq, Hq, Dv)
    exp = _jax_attention(qj, kj, vj, causal=causal, window=window)
    assert rel_err(to_np(got), exp) < TOL[dtype]


def test_attention_kv_len_and_offset_match_jax_oracle():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(s, dtype=np.float32) for s in ((2, 3, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16)))
    lens = np.array([5, 12], np.int32)
    got = ref.attention(*(torch.from_numpy(a) for a in (q, k, v)), q_offset=4,
                        kv_len=torch.from_numpy(lens))
    exp = _jax_attention(q, k, v, q_offset=4, kv_len=jnp.asarray(lens))
    assert rel_err(to_np(got), exp) < TOL["float32"]


@pytest.mark.parametrize("kind", ["rmsnorm", "attention"])
def test_plain_versions_match_pallas_kernels_at_aligned_shape(kind):
    """At a 128-aligned shape the JAX package runs its Pallas kernels; hold the
    port's plain versions against them (interpret mode, as test_kernels.py)."""
    rng = np.random.default_rng(3)
    if kind == "rmsnorm":
        from repro.kernels.rmsnorm import fused_rmsnorm as pallas_rmsnorm

        x, w = rng.standard_normal((256, 128), dtype=np.float32), rng.standard_normal(128, dtype=np.float32)
        exp = pallas_rmsnorm(jnp.asarray(x), jnp.asarray(w), interpret=True)
        got = ref.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    else:
        from repro.kernels.flash_attention import flash_attention as pallas_attention

        q, k, v = (rng.standard_normal(s, dtype=np.float32) for s in ((1, 128, 2, 64), (1, 128, 1, 64), (1, 128, 1, 64)))
        exp = pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
        got = ref.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert rel_err(to_np(got), exp) < TOL["float32"]


def test_ops_on_cpu_take_plain_versions_and_launch_nothing():
    reset_launch_counts()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 5, 40), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal(40, dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 9, 6, 16), dtype=np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 9, 2, 16), dtype=np.float32))
    assert torch.equal(ops.rmsnorm(x, w, gemma=True), ref.rmsnorm(x, w, gemma=True))
    assert torch.equal(ops.attention(q, kv, kv, window=4), ref.attention(q, kv, kv, window=4))
    assert torch.equal(ops.row_parallel_dense(x, w[:, None]), x @ w[:, None])
    assert fused_rmsnorm.launches == 0 and flash_attention.launches == 0


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card raises: only the CPU
    takes the plain version."""
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_rmsnorm(x, x[0])
    q = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
