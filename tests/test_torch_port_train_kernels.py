"""The training slice's kernel module on the CPU: K1's residuals, K2's plain
version and `hop1_trainable`'s gradients against the JAX package (its Pallas
kernels in interpret mode, and autodiff through its einsum reference).
The CUDA kernels are held against these plain versions on the card by
test_torch_port_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bist_tpu.models.layers import linear, mha_init
from bist_tpu.ops import bist_kernels as jk
from bist_tpu_torch.ops import bist_kernels as K
from bist_tpu_torch.weights import params_from_jax
from torch_port_common import CPU, assert_close

TOL = 2e-4
GRAD_TOL = 5e-4
NAMES = ("x", "q_proj", "kv", "wk", "bk", "wv", "bv", "wo", "bo")


def inputs(rng, B, G, Lq, Lk, D, h, masked=True, full_row=False):
    p = mha_init(jax.random.PRNGKey(1), h, D)
    x = rng.standard_normal((B, Lq, D)).astype(np.float32)
    kv = rng.standard_normal((B, G, Lk, D)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.uniform(size=(B, 1, Lk)) > 0.3).astype(np.int32)
        mask[:, :, 0] = 1
        if full_row:
            mask[0] = 0
    q_proj = np.array(linear(p["wq"], jnp.asarray(x)))
    g = rng.standard_normal((B, G, Lq, D)).astype(np.float32)
    return p, x, q_proj, kv, mask, g


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def j(a):
    return None if a is None else jnp.asarray(a)


def weights(p):
    return [p[n][k] for n in ("wk", "wv", "wo") for k in ("w", "b")]


@pytest.mark.parametrize("Lk", [7, 600])
def test_residuals_match_pallas(Lk, rng):
    """concat and lse of hop1_plain(return_residuals=True) against the
    Pallas kernel's (interpret mode; JAX pads Lq to 8, so [:, :, :Lq])."""
    B, G, Lq, D, h = 2, 3, 5, 32, 4
    p, x, q_proj, kv, mask, _ = inputs(rng, B, G, Lq, Lk, D, h)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, p), CPU)
    out, concat, lse = K.hop1_plain(t(x), t(q_proj), t(kv), tp, h, t(mask),
                                    return_residuals=True)
    assert concat.shape == (B, G, Lq, D) and lse.shape == (B, G, Lq, h)
    assert lse.is_contiguous()
    jout, jconcat, jlse = jk.bist_hop1_fused(j(x), j(q_proj), j(kv), p, h, j(mask),
                                             return_residuals=True, interpret=True)
    assert_close(out, jout, TOL, "out")
    assert_close(concat, np.asarray(jconcat)[:, :, :Lq], TOL, "concat")
    assert_close(lse, np.asarray(jlse)[:, :, :Lq], TOL, "lse")
    # on the CPU the wrapper is the plain version
    got = K.hop1_fused(t(x), t(q_proj), t(kv), tp, h, t(mask), return_residuals=True)
    for a, b in zip(got, (out, concat, lse)):
        assert torch.equal(a, b)


def bwd_case(rng, B, G, Lq, Lk, D, h, masked, full_row=False):
    """Identical inputs for both backwards: the JAX forward's residuals, a
    random upstream gradient, d_concat and Dh as the JAX glue makes them."""
    p, x, q_proj, kv, mask, g = inputs(rng, B, G, Lq, Lk, D, h, masked, full_row)
    _, concat, lse = jk.bist_hop1_fused(j(x), j(q_proj), j(kv), p, h, j(mask),
                                        return_residuals=True, interpret=True)
    Lq_pad = concat.shape[2]
    g_pad = jnp.pad(j(g), ((0, 0), (0, 0), (0, Lq_pad - Lq), (0, 0)))
    dcc = jnp.einsum("bgle,de->bgld", g_pad, p["wo"]["w"])
    dh = jnp.sum((dcc * concat).reshape(B, G, Lq_pad, h, D // h), axis=-1)
    return p, q_proj, kv, mask, dcc, dh, lse


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("Lk", [7, 600])
def test_hop1_bwd_plain_matches_pallas(Lk, masked, rng):
    """hop1_bwd_plain against _hop1_bwd_pallas (interpret mode) on the same
    inputs, one kv block (Lk 7) and several (Lk 600): dq, dkv, dWk, dWv, dbv
    to 2e-4; dbk, analytically zero, to 2e-4 absolute."""
    B, G, Lq, D, h = 2, 3, 5, 32, 4
    p, q_proj, kv, mask, dcc, dh, lse = bwd_case(rng, B, G, Lq, Lk, D, h, masked)
    w = (p["wk"]["w"], p["wk"]["b"], p["wv"]["w"], p["wv"]["b"])
    jdq, jdkv, jdwk, jdwv, jdbk, jdbv = jk._hop1_bwd_pallas(
        j(q_proj), j(kv), j(mask), dcc, dh, lse, *w, h, interpret=True)
    got = K.hop1_bwd_plain(t(q_proj), t(kv), t(mask), t(dcc)[:, :, :Lq],
                           t(dh)[:, :, :Lq].contiguous(), t(lse)[:, :, :Lq].contiguous(),
                           *(t(a) for a in w), h)
    want = (np.asarray(jdq)[:, :Lq], jdkv, jdwk, jdwv, None, jdbv)
    for name, a, b in zip(("dq", "dkv", "dWk", "dWv", "dbk", "dbv"), got, want):
        if name == "dbk":
            np.testing.assert_allclose(a.numpy(), np.asarray(jdbk), atol=TOL, rtol=0)
            continue
        assert_close(a, b, TOL, name)
    # the wrapper on the CPU is the plain version, and launches nothing
    before = K.hop1_bwd.launches
    again = K.hop1_bwd(t(q_proj), t(kv), t(mask), t(dcc)[:, :, :Lq],
                       t(dh)[:, :, :Lq].contiguous(), t(lse)[:, :, :Lq].contiguous(),
                       *(t(a) for a in w), h)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert K.hop1_bwd.launches == before


def torch_grads(fn, x, q_proj, kv, p, h, mask, g):
    leaves = [t(x), t(q_proj), t(kv)] + [t(w) for w in weights(p)]
    leaves = [a.clone().requires_grad_(True) for a in leaves]
    out = fn(*leaves, h, t(mask))
    return torch.autograd.grad((out * t(g)).sum(), leaves)


def jax_grads(fn, x, q_proj, kv, p, h, mask, g):
    def loss(*a):
        return jnp.sum(fn(*a, h, j(mask)) * j(g))
    return jax.grad(loss, argnums=tuple(range(9)))(j(x), j(q_proj), j(kv),
                                                    *weights(p))


def plain_fn(x, q, kv, wk, bk, wv, bv, wo, bo, h, mask):
    p = {"wk": {"w": wk, "b": bk}, "wv": {"w": wv, "b": bv}, "wo": {"w": wo, "b": bo}}
    return K.hop1_plain(x, q, kv, p, h, mask)


@pytest.mark.parametrize("masked", [True, False])
def test_hop1_bwd_plain_equals_autograd_through_hop1_plain(masked, rng):
    """hop1_trainable (K2's plain version on the CPU) gives the gradients
    of autograd through hop1_plain, a fully masked row included."""
    args = inputs(rng, 2, 3, 5, 9, 32, 4, masked, full_row=masked)
    p, x, q_proj, kv, mask, g = args
    got = torch_grads(K.hop1_trainable.apply, x, q_proj, kv, p, 4, mask, g)
    want = torch_grads(plain_fn, x, q_proj, kv, p, 4, mask, g)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("B,G,Lk,D,h", [
    pytest.param(2, 3, 7, 32, 4, id="7"),
    pytest.param(2, 3, 600, 32, 4, id="600"),
    (2, 3, 7, 12, 3),          # widths K1/K2 pad: d_k 4, D % 8 != 0
    (2, 3, 7, 30, 3),          # d_k 10
    (2, 2, 9, 120, 8),         # d_k 15
    (1, 2, 6, 520, 8),         # above 512, d_k 65
    (1, 2, 5, 1024, 8),        # two head groups in K2
])
def test_hop1_trainable_grads_match_jax(B, G, Lk, D, h, rng):
    """All 9 gradients against jax.grad of JAX's hop1_trainable (Pallas
    forward and backward, interpret mode) and of _hop1_flat (autodiff
    through the einsum reference), to 5e-4."""
    p, x, q_proj, kv, mask, g = inputs(rng, B, G, 5, Lk, D, h)
    got = torch_grads(K.hop1_trainable.apply, x, q_proj, kv, p, h, mask, g)
    for ref in (jk.hop1_trainable, jk._hop1_flat):
        want = jax_grads(ref, x, q_proj, kv, p, h, mask, g)
        for name, a, b in zip(NAMES, got, want):
            if name == "bk":            # analytically zero: residue only
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL,
                                           rtol=0, err_msg=name)
            else:
                assert_close(a, b, GRAD_TOL, f"{ref.__name__} {name}")


def test_hop1_trainable_fully_masked_row_matches_autodiff(rng):
    """A batch row with every kv column masked and a nonzero upstream
    gradient: the port follows autodiff through the einsum reference
    (_hop1_flat): uniform attention over the Lk columns, no score gradient.
    JAX's Pallas kernels differ there (they count their padding columns and
    apply ds at masked columns), so they are not the reference for it."""
    h = 4
    p, x, q_proj, kv, mask, g = inputs(rng, 2, 3, 5, 7, 32, h, full_row=True)
    got = torch_grads(K.hop1_trainable.apply, x, q_proj, kv, p, h, mask, g)
    want = jax_grads(jk._hop1_flat, x, q_proj, kv, p, h, mask, g)
    for name, a, b in zip(NAMES, got, want):
        tol = dict(atol=GRAD_TOL, rtol=0) if name == "bk" \
            else dict(atol=GRAD_TOL, rtol=GRAD_TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **tol)
    assert np.abs(got[2][0].numpy()).max() > 0      # dv reaches the masked row


def test_hop1_trainable_t2s_view_matches_jax(rng):
    """kv as the t2s direction passes it, a (B, T, S, D) grid viewed with T
    and S swapped: the gradient comes back through the view."""
    h, B, T, S, Lq, D = 4, 2, 6, 3, 5, 32
    p, x, q_proj, _, _, g = inputs(rng, B, S, Lq, T, D, h)
    grid = rng.standard_normal((B, T, S, D)).astype(np.float32)
    mask = np.ones((B, 1, T), np.int32)
    mask[1, :, 4:] = 0
    tgrid = t(grid).clone().requires_grad_(True)
    leaves = [t(a).clone().requires_grad_(True) for a in [x, q_proj] + weights(p)]
    out = K.hop1_trainable.apply(leaves[0], leaves[1], tgrid.transpose(1, 2),
                                 *leaves[2:], h, t(mask))
    dgrid = torch.autograd.grad((out * t(g)).sum(), tgrid)[0]

    def loss(gr):
        o = jk._hop1_flat(j(x), j(q_proj), jnp.swapaxes(gr, 1, 2), *weights(p), h,
                          j(mask))
        return jnp.sum(o * j(g))
    assert_close(dgrid, jax.grad(loss)(j(grid)), GRAD_TOL, "d grid")


def pallas_masked_row_divergence(seed=0, B=2, G=3, Lq=4, Lk=5, D=16, h=2):
    """max |Δ| of each gradient between jax.grad of JAX's hop1_trainable
    (Pallas, interpret mode) and of _hop1_flat, with batch row 1 fully
    masked and the loss Σ out²: the divergence the port does not copy."""
    rng = np.random.default_rng(seed)
    p, x, q_proj, kv, mask, _ = inputs(rng, B, G, Lq, Lk, D, h)
    mask[1] = 0

    def grads(fn):
        loss = lambda *a: jnp.sum(fn(*a, h, j(mask)) ** 2)
        return jax.grad(loss, argnums=tuple(range(9)))(j(x), j(q_proj), j(kv),
                                                        *weights(p))
    return {n: float(np.abs(np.asarray(a) - np.asarray(b)).max())
            for n, a, b in zip(NAMES, grads(jk.hop1_trainable), grads(jk._hop1_flat))}


def test_pallas_backward_differs_on_a_fully_masked_row():
    """Why the port's reference there is autodiff, not the Pallas kernel:
    on a fully masked row the Pallas backward is far from autodiff (it
    applies ds at masked columns and counts its padding columns)."""
    diff = pallas_masked_row_divergence()
    for name in ("q_proj", "kv", "wk", "wv", "bv"):
        assert diff[name] > 1e-2, diff
