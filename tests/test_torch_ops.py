"""The port's operators against the JAX package's, on the CPU.

Each kernel's plain PyTorch version (what a CPU tensor runs) is held
against the JAX function as the JAX package's own tests run it (Pallas in
interpret mode); the CUDA kernels themselves are held against their plain
versions in tests/test_torch_kernels.py, on the card. Inputs come from a
numpy seed and go to both frameworks as numpy arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uncrtaints_tpu_torch import ops as tops


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (JAX arrays are read-only)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ------------------------------------------------------------------ K1 --

# (B, T, H, W, C, heads): the shapes of the card's kernel variants at small
# sizes. T of 1, 2, 3 and 5; 8 channels a head (the paper's), 4 (U-TAE's:
# two heads a 16-byte bf16 vector), 16 (a head over two vectors) and 5 (the
# generic kernels); ragged H x W of 35 and 15 pixels
K1_CPU_SHAPES = [(2, 3, 8, 8, 128, 16), (1, 1, 4, 4, 64, 16), (1, 2, 5, 7, 20, 4),
                 (1, 5, 4, 4, 128, 8), (2, 3, 3, 5, 64, 16)]


@pytest.mark.parametrize("shape", K1_CPU_SHAPES)
@pytest.mark.parametrize("dtype,tol", [
    # fp32: both accumulate the same fp32 products over T; only the order
    # of the three adds may differ
    ("float32", 1e-6),
    # bf16: one final rounding each, plus the JAX kernel's
    # rounding of fp32 inputs; 2e-2 as the JAX package's bf16 test
    ("bfloat16", 2e-2),
])
def test_att_group_plain_matches_jax_kernel(rng, dtype, tol, shape):
    from uncrtaints_tpu.ops.pallas_aggregate import att_group_aggregate
    B, T, H, W, C, heads = shape
    x = rng.standard_normal((B, T, H, W, C)).astype(np.float32)
    a = rng.random((B, T, H, W, heads)).astype(np.float32)
    jx, ja = jnp.asarray(x).astype(dtype), jnp.asarray(a).astype(dtype)
    ref = att_group_aggregate(jx, ja, interpret=True)
    got = tops.att_group_aggregate(_t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype)),
                                   _t(np.asarray(ja.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, H, W, C)
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_att_group_wrapper_rejects_bad_input():
    x = torch.zeros(1, 2, 4, 4, 12)
    with pytest.raises(ValueError, match="multiple of heads"):
        tops.att_group_aggregate(x, torch.zeros(1, 2, 4, 4, 5))
    with pytest.raises(TypeError):
        tops.att_group_aggregate(x, torch.zeros(1, 2, 4, 4, 4, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        tops.att_group_aggregate(x.half(), torch.zeros(1, 2, 4, 4, 4).half())
    with pytest.raises(ValueError, match="contiguous"):
        tops.att_group_aggregate(x.transpose(2, 3), torch.zeros(1, 2, 4, 4, 4))
    with pytest.raises(ValueError):
        tops.att_group_aggregate(x, torch.zeros(1, 3, 4, 4, 4))
    launches = tops.att_group_aggregate.launches
    tops.att_group_aggregate(x, torch.zeros(1, 2, 4, 4, 4))  # CPU: plain version
    assert tops.att_group_aggregate.launches == launches


# -------------------------------------------------------------- K1-bwd --

def _bf16_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _ulp_bf16(ref):
    """One bf16 ulp at each element of ref (fp32 array of bf16 values)."""
    e = np.floor(np.log2(np.maximum(np.abs(ref), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("shape,tile", [
    ((2, 3, 8, 8, 128, 16), 16),   # several row tiles
    ((1, 2, 5, 7, 20, 4), None),   # ragged: rows 35, C 20, 5 channels a head
    *((shape, None) for shape in K1_CPU_SHAPES[1:2] + K1_CPU_SHAPES[3:]),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_att_group_bwd_plain_matches_jax_kernel(rng, shape, tile, dtype):
    from uncrtaints_tpu.ops.pallas_aggregate import _bwd_call
    B, T, H, W, C, heads = shape
    x = rng.standard_normal((B, T, H, W, C)).astype(np.float32)
    a = rng.random((B, T, H, W, heads)).astype(np.float32)
    g = rng.standard_normal((B, H, W, C)).astype(np.float32)
    if dtype == "bfloat16":
        x, a, g = _bf16_np(x), _bf16_np(a), _bf16_np(g)
    jd = getattr(jnp, dtype)
    rdx, rda = _bwd_call(jnp.asarray(x).astype(jd), jnp.asarray(a).astype(jd),
                         jnp.asarray(g).astype(jd), tile, True)
    td = getattr(torch, dtype)
    dx, da = tops.att_group_aggregate_bwd(_t(x).to(td), _t(a).to(td), _t(g).to(td))
    assert dx.dtype == td and da.dtype == td
    rdx, rda = np.asarray(rdx, np.float32), np.asarray(rda, np.float32)
    if dtype == "float32":
        # dx: the same fp32 product; dattn: a head's sum in another order,
        # 1e-6 for up to 8 channels a head (the rounding of a sum in
        # another order grows with its terms: 1e-6 for each 8 of them)
        np.testing.assert_array_equal(_np(dx), rdx)
        np.testing.assert_allclose(_np(da), rda, rtol=0, atol=1e-6 * max(1, C // heads // 8))
    else:
        # one rounding to bf16 each: at most one bf16 ulp apart
        np.testing.assert_array_equal(_np(dx), rdx)
        assert (np.abs(_np(da) - rda) <= _ulp_bf16(rda)).all()


@pytest.mark.parametrize("shape", [(2, 3, 8, 8, 128, 16), (1, 2, 5, 7, 20, 4)])
def test_att_group_autograd_matches_jax_grad(rng, shape):
    """The port's autograd gradients (Function -> plain backward) against
    jax.grad through the JAX kernel's custom VJP (interpret mode), as
    tests/test_pallas_aggregate.py holds the VJP."""
    import jax
    from uncrtaints_tpu.ops.pallas_aggregate import att_group_aggregate
    B, T, H, W, C, heads = shape
    x = rng.standard_normal((B, T, H, W, C)).astype(np.float32)
    a = rng.random((B, T, H, W, heads)).astype(np.float32)
    cot = rng.standard_normal((B, H, W, C)).astype(np.float32)
    loss = lambda x_, a_: (att_group_aggregate(x_, a_, None, True) * cot).sum()
    rdx, rda = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(a))
    tx, ta = _t(x).requires_grad_(), _t(a).requires_grad_()
    (tops.att_group_aggregate(tx, ta) * _t(cot)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(rdx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(ta.grad), np.asarray(rda), rtol=0, atol=1e-6)


def test_att_group_no_grad_skips_function():
    x = torch.zeros(1, 2, 4, 4, 8, requires_grad=True)
    a = torch.zeros(1, 2, 4, 4, 2)
    assert tops.att_group_aggregate(x, a).grad_fn is not None
    with torch.no_grad():
        assert tops.att_group_aggregate(x, a).grad_fn is None
    with pytest.raises(ValueError, match="g must be"):
        tops.att_group_aggregate_bwd(x.detach(), a, torch.zeros(1, 4, 4, 4))


# ------------------------------------------------------------------ K5 --

@pytest.mark.parametrize("pads", [((1, 1), (1, 1)),   # SAME
                                  ((0, 0), (0, 0)),   # VALID
                                  ((2, 2), (2, 2))],  # FULL (the input gradient)
                         ids=["same", "valid", "full"])
@pytest.mark.parametrize("C", [128, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_stencil_plain_matches_jax_kernel(rng, pads, C, dtype):
    from uncrtaints_tpu.ops.pallas_dwconv import dw_stencil
    x = rng.standard_normal((2, 12, 10, C)).astype(np.float32)
    w = rng.standard_normal((3, 3, 1, C)).astype(np.float32)   # HWIO
    if dtype == "bfloat16":
        x, w = _bf16_np(x), _bf16_np(w)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(dw_stencil(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
                                pads, tile_h=4, interpret=True), np.float32)
    wt = _t(np.transpose(w, (3, 2, 0, 1))).to(td).contiguous()   # [C,1,kh,kw]
    got = tops.dw_stencil(_t(x).to(td), wt, pads)
    assert got.dtype == td and got.shape == ref.shape
    if dtype == "float32":
        # the same fp32 taps in the same order; XLA may contract a
        # multiply-add of the JAX side into an FMA, which differs in the
        # last bits: 1e-6 of the largest value
        np.testing.assert_allclose(_np(got), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    else:
        assert (np.abs(_np(got) - ref) <= _ulp_bf16(ref)).all()


@pytest.mark.parametrize("kh,kw", [(1, 3), (3, 1)])
def test_dw_stencil_plain_strip_kernels(rng, kh, kw):
    from uncrtaints_tpu.ops.pallas_dwconv import dw_stencil
    x = rng.standard_normal((1, 9, 11, 32)).astype(np.float32)
    w = rng.standard_normal((kh, kw, 1, 32)).astype(np.float32)
    pads = ((0, 0), (0, 0))
    ref = dw_stencil(jnp.asarray(x), jnp.asarray(w), pads, interpret=True)
    got = tops.dw_stencil(_t(x), _t(np.transpose(w, (3, 2, 0, 1))).contiguous(), pads)
    ref = np.asarray(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_dw_stencil_wrapper_rejects_bad_input():
    x = torch.zeros(1, 6, 6, 8)
    w = torch.zeros(8, 1, 3, 3)
    with pytest.raises(ValueError, match=r"\[C,1,kh,kw\]"):
        tops.dw_stencil(x, torch.zeros(4, 1, 3, 3), ((1, 1), (1, 1)))
    with pytest.raises(TypeError):
        tops.dw_stencil(x, w.bfloat16(), ((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="negative"):
        tops.dw_stencil(x, w, ((-1, 1), (1, 1)))
    with pytest.raises(ValueError, match="no output"):
        tops.dw_stencil(torch.zeros(1, 1, 6, 8), w, ((0, 0), (0, 0)))
    with pytest.raises(ValueError, match="contiguous"):
        tops.dw_stencil(x.transpose(1, 2), w, ((1, 1), (1, 1)))
    n = tops.dw_stencil.launches
    tops.dw_stencil(x, w, ((1, 1), (1, 1)))   # CPU: the plain version
    assert tops.dw_stencil.launches == n


# ------------------------------------------------------------------ K2 --

@pytest.mark.parametrize("kh,kw,pads", [
    (3, 3, ((1, 1), (1, 1))),   # SAME
    (3, 3, ((0, 0), (0, 0))),   # VALID (the train step's reflect-padded input)
    (1, 3, ((0, 0), (0, 0))),   # the border-strip kernels of the JAX package
    (3, 1, ((0, 0), (0, 0))),
], ids=["3x3_same", "3x3_valid", "1x3", "3x1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_kernel_grad_plain_matches_jax_kernel(rng, kh, kw, pads, dtype):
    from uncrtaints_tpu.ops.pallas_dwgrad import dw_kernel_grad
    N, H, W, C = 2, 16, 12, 32
    (pt, pb), (pl, pr) = pads
    Ho, Wo = H + pt + pb - kh + 1, W + pl + pr - kw + 1
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    g = rng.standard_normal((N, Ho, Wo, C)).astype(np.float32)
    if dtype == "bfloat16":
        x, g = _bf16_np(x), _bf16_np(g)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(dw_kernel_grad(jnp.asarray(x).astype(jd), jnp.asarray(g).astype(jd),
                                    pads, kh, kw, tile_h=4, interpret=True))
    got = tops.dw_kernel_grad(_t(x).to(td), _t(g).to(td), pads, kh, kw)
    assert got.dtype == torch.float32 and got.shape == (C, 1, kh, kw)
    ref = np.transpose(ref, (3, 2, 0, 1))                     # -> [C,1,kh,kw]
    # fp32 sums of N*Ho*Wo products in another order: relative to sum|x*g|
    xp = np.pad(x, [(0, 0), (pt, pb), (pl, pr), (0, 0)])
    scale = np.stack([np.abs(xp[:, dy:dy + Ho, dx:dx + Wo] * g).sum(axis=(0, 1, 2))
                      for dy in range(kh) for dx in range(kw)], -1).reshape(C, 1, kh, kw)
    assert (np.abs(_np(got) - ref) / scale).max() <= 1e-5


def test_dw_kernel_grad_wrapper_rejects_bad_input():
    x = torch.zeros(1, 6, 6, 8)
    with pytest.raises(ValueError, match="g must be"):
        tops.dw_kernel_grad(x, torch.zeros(1, 6, 6, 8), ((0, 0), (0, 0)), 3, 3)
    with pytest.raises(TypeError):
        tops.dw_kernel_grad(x, torch.zeros(1, 4, 4, 8).bfloat16(), ((0, 0), (0, 0)), 3, 3)
    n = tops.dw_kernel_grad.launches
    gw = tops.dw_kernel_grad(x, torch.ones(1, 4, 4, 8), ((0, 0), (0, 0)), 3, 3)
    assert gw.shape == (8, 1, 3, 3) and tops.dw_kernel_grad.launches == n


REFLECT_SIZES = [(8, 8), (7, 10), (3, 5), (2, 2)]
ONE = ((1, 1), (1, 1))


@pytest.mark.parametrize("hw", REFLECT_SIZES)
def test_dw_stencil_plain_reflect_matches_jax_conv2d(rng, hw):
    """dw_stencil(mode="reflect") on the unpadded input against the value of
    the JAX Conv2d(groups=C, padding_mode="reflect")."""
    import jax
    from uncrtaints_tpu.models import layers as jl
    C = 16
    x = rng.standard_normal((2, *hw, C)).astype(np.float32)
    jm = jl.Conv2d(C, kernel=3, pad=1, padding_mode="reflect", use_bias=False, groups=C)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    w = _t(np.transpose(np.asarray(v["params"]["kernel"]), (3, 2, 0, 1))).contiguous()
    got = tops.dw_stencil(_t(x), w, ONE, "reflect")
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    # the plain version is the explicit pad followed by the zero-mode VALID sum
    xp = torch.nn.functional.pad(_t(x).permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    valid = tops.dw_stencil(xp.permute(0, 2, 3, 1).contiguous(), w, ((0, 0), (0, 0)))
    assert torch.equal(got, valid)


@pytest.mark.parametrize("hw", REFLECT_SIZES + [(3, 3), (2, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_stencil_reflect_adjoint_plain_is_the_adjoint(rng, hw, dtype):
    """<dw_stencil(x, reflect), g> = <x, adjoint(g)> through torch autograd of
    an explicit reflect pad and F.conv2d: the folded adjoint's plain version
    returns exactly that input gradient (fp32: 1e-6 of its largest value;
    bf16: one rounding of it, within one ulp)."""
    C = 12
    td = getattr(torch, dtype)
    g = _t(rng.standard_normal((2, *hw, C))).to(td)
    w = _t(rng.standard_normal((C, 1, 3, 3))).to(td)
    got = tops.dw_stencil_reflect_adjoint(g, w)
    assert got.dtype == td and got.shape == g.shape
    x = torch.zeros(2, *hw, C, requires_grad=True)
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    y = torch.nn.functional.conv2d(xp, w.float(), groups=C).permute(0, 2, 3, 1)
    (ref,) = torch.autograd.grad(y, x, g.float())
    if dtype == "float32":
        assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    else:
        assert (np.abs(_np(got) - _np(ref)) <= _ulp_bf16(_np(ref))).all()


def test_dw_reflect_wrappers_reject_bad_input():
    """Reflect mode takes a 3x3 kernel with pads of one on a map of at least
    2x2, in the forward, the adjoint and the weight gradient."""
    w = torch.zeros(8, 1, 3, 3)
    x = torch.zeros(1, 6, 6, 8)
    for bad in (torch.zeros(1, 1, 6, 8), torch.zeros(1, 6, 1, 8)):
        with pytest.raises(ValueError, match="H, W >= 2"):
            tops.dw_stencil(bad, w, ONE, "reflect")
        with pytest.raises(ValueError, match="H, W >= 2"):
            tops.dw_stencil_reflect_adjoint(bad, w)
        with pytest.raises(ValueError, match="H, W >= 2"):
            tops.dw_kernel_grad(bad, bad, ONE, 3, 3, "reflect")
    with pytest.raises(ValueError, match="3x3"):
        tops.dw_stencil(x, torch.zeros(8, 1, 1, 3), ((0, 0), (1, 1)), "reflect")
    with pytest.raises(ValueError, match="3x3"):
        tops.dw_stencil_reflect_adjoint(x, torch.zeros(8, 1, 3, 1))
    with pytest.raises(ValueError, match="3x3"):
        tops.dw_kernel_grad(x, x, ((1, 1), (0, 0)), 3, 1, "reflect")
    with pytest.raises(ValueError, match="pads"):
        tops.dw_stencil(x, w, ((0, 0), (0, 0)), "reflect")
    with pytest.raises(ValueError, match="pads"):
        tops.dw_kernel_grad(x, torch.zeros(1, 4, 4, 8), ((0, 0), (0, 0)), 3, 3, "reflect")
    with pytest.raises(ValueError, match="mode"):
        tops.dw_stencil(x, w, ONE, "replicate")
    with pytest.raises(ValueError, match="mode"):
        tops.dw_kernel_grad(x, x, ONE, 3, 3, "circular")
    n5, n2 = tops.dw_stencil.launches, tops.dw_kernel_grad.launches
    assert tops.dw_stencil(x, w, ONE, "reflect").shape == x.shape     # CPU: plain
    assert tops.dw_stencil_reflect_adjoint(x, w).shape == x.shape
    assert tops.dw_kernel_grad(x, x, ONE, 3, 3, "reflect").shape == (8, 1, 3, 3)
    assert (tops.dw_stencil.launches, tops.dw_kernel_grad.launches) == (n5, n2)


@pytest.mark.parametrize("hw", REFLECT_SIZES)
def test_dw_kernel_grad_plain_reflect_matches_padded_zero_mode(rng, hw):
    """dw_kernel_grad(mode="reflect") on the unpadded x equals the zero-mode
    VALID gradient on the explicitly reflect-padded x."""
    C = 12
    x = _t(rng.standard_normal((2, *hw, C)).astype(np.float32))
    g = _t(rng.standard_normal((2, *hw, C)).astype(np.float32))
    got = tops.dw_kernel_grad(x, g, ONE, 3, 3, "reflect")
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    ref = tops.dw_kernel_grad(xp.permute(0, 2, 3, 1).contiguous(), g, ((0, 0), (0, 0)), 3, 3)
    assert got.shape == (C, 1, 3, 3) and torch.equal(got, ref)


# ------------------------------------------------------------------ K3 --

def _group_stats(x, G):
    N = x.shape[0]
    xg = x.astype(np.float32).reshape(N, -1, G, x.shape[-1] // G)
    m = xg.mean(axis=(1, 3))
    return m, 1.0 / np.sqrt(xg.var(axis=(1, 3)) + 1e-5)


def _k3_case(rng, case):
    """The configurations of tests/test_pallas_kernels.py (norm -> GELU ->
    GEMM with statistics; GELU + SE + affine + GELU epilogue) and the
    fused-MBConv pw1 configuration (affine prologue, no GELU, affine + GELU
    epilogue)."""
    N, P, C, C2, G = {"stats": (2, 1024, 128, 256, 4),
                      "epilogue": (2, 512, 128, 128, 1),
                      "pw1": (2, 512, 128, 256, 1)}[case]
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    x = bf(rng.standard_normal((N, P, C)).astype(np.float32))
    w = bf(rng.standard_normal((C, C2)).astype(np.float32) * 0.05)
    scale = rng.standard_normal(C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    kw = dict(groups_in=G, groups_out=4 if case == "stats" else 1)
    if case == "stats":
        mean, coef = _group_stats(x, G)
        kw.update(do_gelu=True, do_stats=True)
    else:
        mean, coef = np.zeros((N, 1), np.float32), np.ones((N, 1), np.float32)
        oaff = (rng.standard_normal(C2).astype(np.float32),
                rng.standard_normal(C2).astype(np.float32))
        kw.update(out_affine=oaff, out_gelu=True, do_stats=False,
                  do_gelu=case == "epilogue")
        if case == "epilogue":
            kw["se"] = rng.random((N, C)).astype(np.float32)
    return x, mean, coef, scale, bias, w, kw


@pytest.mark.parametrize("case", ["stats", "epilogue", "pw1"])
def test_norm_gelu_matmul_plain_matches_jax_kernel(rng, case):
    from uncrtaints_tpu.ops.pallas_mbconv import norm_gelu_matmul
    x, mean, coef, scale, bias, w, kw = _k3_case(rng, case)
    jkw = dict(kw)
    if "out_affine" in kw:
        jkw["out_affine"] = tuple(jnp.asarray(a) for a in kw["out_affine"])
    if "se" in kw:
        jkw["se"] = jnp.asarray(kw["se"])
    ref, r1, r2 = norm_gelu_matmul(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mean), jnp.asarray(coef),
        jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(w).astype(jnp.bfloat16),
        tile=512, interpret=True, **jkw)
    tkw = {k: (tuple(_t(a) for a in v) if k == "out_affine" else
               _t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    out, s1, s2 = tops.norm_gelu_matmul(
        _t(x).bfloat16(), _t(mean), _t(coef), _t(scale), _t(bias),
        _t(w).bfloat16(), **tkw)
    assert out.dtype == torch.bfloat16 and out.shape == tuple(ref.shape)
    ref = np.asarray(ref, np.float32)
    # the JAX package's tolerances for this kernel (test_pallas_kernels.py):
    # bf16 output, the TPU kernel's A&S erf against the exact erf here
    assert np.abs(_np(out) - ref).max() <= 0.05 * np.abs(ref).max()
    if kw["do_stats"]:
        np.testing.assert_allclose(_np(s1), np.asarray(r1), rtol=2e-3, atol=2.0)
        np.testing.assert_allclose(_np(s2), np.asarray(r2), rtol=2e-3)
    else:
        assert not s1.any() and not s2.any()


def test_norm_gelu_matmul_wrapper_rejects_bad_input():
    x = torch.zeros(2, 128, 32, dtype=torch.bfloat16)
    m, c = torch.zeros(2, 4), torch.ones(2, 4)
    s, b = torch.ones(32), torch.zeros(32)
    with pytest.raises(TypeError):
        tops.norm_gelu_matmul(x, m, c, s, b, torch.zeros(32, 16))  # w fp32
    with pytest.raises(ValueError):
        tops.norm_gelu_matmul(x, m, c, s, b, torch.zeros(16, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="not whole"):
        tops.norm_gelu_matmul(x, m, c, s, b, torch.zeros(32, 18, dtype=torch.bfloat16))


# ------------------------------------------------------------------ K4 --

def _k4_case(rng, N, H, W, C, G):
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    x = bf(rng.standard_normal((N, H, W, C)).astype(np.float32))
    w = rng.standard_normal((3, 3, C)).astype(np.float32) * 0.2
    scale = rng.standard_normal(C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    if G == 1:  # the batch-norm form: a plain per-channel affine
        mean, coef = np.zeros((N, 1), np.float32), np.ones((N, 1), np.float32)
    else:
        mean, coef = _group_stats(x, G)
    return x, mean, coef, scale, bias, w


@pytest.mark.parametrize("shape,tile_h", [
    ((1, 32, 256, 256, 4), 16),   # the JAX package's own test shape
    ((2, 24, 16, 128, 1), 8),     # H not a multiple of 16; the batch-norm form
    ((1, 6, 8, 128, 4), 2),
])
def test_norm_gelu_dwconv_plain_matches_jax_kernel(rng, shape, tile_h):
    from uncrtaints_tpu.ops.pallas_mbconv import norm_gelu_dwconv3x3
    N, H, W, C, G = shape
    args = _k4_case(rng, *shape)
    ref, r1, r2 = norm_gelu_dwconv3x3(
        jnp.asarray(args[0]).astype(jnp.bfloat16), *(jnp.asarray(a) for a in args[1:]),
        groups_in=G, groups_out=G, tile_h=tile_h, interpret=True)
    out, s1, s2 = tops.norm_gelu_dwconv3x3(
        _t(args[0]).bfloat16(), *(_t(a) for a in args[1:]), groups_in=G, groups_out=G)
    assert out.dtype == torch.bfloat16 and out.shape == tuple(ref.shape)
    ref = np.asarray(ref, np.float32)
    # the JAX package's tolerance for this kernel (test_pallas_kernels.py):
    # bf16 output, the TPU kernel's A&S erf against the exact erf here
    assert np.abs(_np(out) - ref).max() <= 0.05 * np.abs(ref).max()
    np.testing.assert_allclose(_np(s1), np.asarray(r1), rtol=2e-3, atol=2.0)
    np.testing.assert_allclose(_np(s2), np.asarray(r2), rtol=2e-3)


@pytest.mark.parametrize("shape", [(2, 9, 7, 12, 3), (1, 2, 2, 8, 1), (2, 16, 16, 32, 4)])
def test_norm_gelu_dwconv_plain_matches_lax_conv_fp32(rng, shape):
    """fp32 end to end against an independent reference: exact-erf GELU,
    jnp reflect pad, lax depthwise conv. Any H, W >= 2, no tile constraint.
    Tolerance 1e-5 of max|out| (fp32 sums of nine products in another
    order); the statistics rtol 1e-5."""
    import jax
    N, H, W, C, G = shape
    x, mean, coef, scale, bias, w = _k4_case(rng, *shape)
    x = x + 1e-3 * rng.standard_normal(x.shape).astype(np.float32)  # not bf16-exact
    mb = np.repeat(mean, C // G, -1)[:, None, None]
    cb = np.repeat(coef, C // G, -1)[:, None, None]
    h = jax.nn.gelu((jnp.asarray(x) - mb) * cb * scale + bias, approximate=False)
    hp = jnp.pad(h, [(0, 0), (1, 1), (1, 1), (0, 0)], mode="reflect")
    ref = np.asarray(jax.lax.conv_general_dilated(
        hp, jnp.asarray(w)[:, :, None, :], (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=C,
        precision=jax.lax.Precision.HIGHEST))
    out, s1, s2 = tops.norm_gelu_dwconv3x3(*(_t(a) for a in (x, mean, coef, scale, bias, w)),
                                           groups_in=G, groups_out=G)
    assert out.dtype == torch.float32
    assert np.abs(_np(out) - ref).max() <= 1e-5 * np.abs(ref).max()
    rg = ref.reshape(N, H * W, G, C // G)
    np.testing.assert_allclose(_np(s1), rg.sum(axis=(1, 3)), rtol=1e-5,
                               atol=1e-5 * np.abs(rg).sum(axis=(1, 3)).max())
    np.testing.assert_allclose(_np(s2), (rg ** 2).sum(axis=(1, 3)), rtol=1e-5)


def test_norm_gelu_dwconv_stats_are_of_the_rounded_output(rng):
    """sum and sumsq are taken after the cast to bf16, as the JAX kernel
    takes them from its output block."""
    args = [_t(a) for a in _k4_case(rng, 2, 8, 8, 16, 4)]
    out, s1, s2 = tops.norm_gelu_dwconv3x3(args[0].bfloat16(), *args[1:])
    og = out.float().view(2, 64, 4, 4)
    assert torch.equal(s1, og.sum(dim=(1, 3))) and torch.equal(s2, og.square().sum(dim=(1, 3)))


def test_norm_gelu_dwconv_wrapper_rejects_bad_input():
    x = torch.zeros(2, 4, 4, 16)
    m, c, s, b = torch.zeros(2, 4), torch.ones(2, 4), torch.ones(16), torch.zeros(16)
    w = torch.zeros(3, 3, 16)
    with pytest.raises(ValueError, match=r"w \[3,3,C\]"):
        tops.norm_gelu_dwconv3x3(x, m, c, s, b, torch.zeros(16, 1, 3, 3))
    with pytest.raises(TypeError):
        tops.norm_gelu_dwconv3x3(x.half(), m, c, s, b, w)
    with pytest.raises(ValueError, match="H, W >= 2"):
        tops.norm_gelu_dwconv3x3(torch.zeros(2, 1, 4, 16), m, c, s, b, w)
    with pytest.raises(ValueError, match="not a multiple"):
        tops.norm_gelu_dwconv3x3(x, m, c, s, b, w, groups_out=3)
    with pytest.raises(ValueError, match="contiguous"):
        tops.norm_gelu_dwconv3x3(x.transpose(1, 2), m, c, s, b, w)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.norm_gelu_dwconv3x3(x.to("meta"), m, c, s, b, w)
    n = tops.norm_gelu_dwconv3x3.launches
    x.requires_grad_()  # the CPU runs the plain version, which is differentiable
    out, _, _ = tops.norm_gelu_dwconv3x3(x, m, c, s, b, w)
    assert out.requires_grad and tops.norm_gelu_dwconv3x3.launches == n


def _jax_pool(out, c2, o2):
    """The SE reduction of the JAX fused body before its division by H*W
    (uncrtaints_tpu/models/blocks.py, _fused_body): fp32 exact-erf GELU of the
    affine of the depthwise output, summed over the pixels."""
    import jax
    g = jax.nn.gelu(jnp.asarray(out).astype(jnp.float32) * c2 + o2, approximate=False)
    return np.asarray(g.sum(axis=(1, 2)))


@pytest.mark.parametrize("shape,tile_h", [((1, 32, 256, 256, 1), 16), ((2, 24, 16, 128, 4), 8)])
def test_norm_gelu_dwconv_pool_matches_jax_expression_bf16(rng, shape, tile_h):
    """``pool_affine`` against the JAX expression, bf16. On the port's own
    output the two are the same fp32 reduction in another order: 1e-5 of
    sum|gelu|. On the JAX kernel's own output (interpret mode) the inputs
    of the reduction differ by the two kernels' erf (A&S against exact), so
    that comparison holds the statistics' tolerance of the JAX package's
    kernel test, rtol 2e-3 with atol 2e-3 of sum|gelu|."""
    from uncrtaints_tpu.ops.pallas_mbconv import norm_gelu_dwconv3x3
    N, H, W, C, G = shape
    args = _k4_case(rng, *shape)
    c2 = rng.standard_normal(C).astype(np.float32)
    o2 = rng.standard_normal(C).astype(np.float32)
    ref, _, _ = norm_gelu_dwconv3x3(
        jnp.asarray(args[0]).astype(jnp.bfloat16), *(jnp.asarray(a) for a in args[1:]),
        groups_in=G, groups_out=G, tile_h=tile_h, interpret=True)
    out, s1, s2, pool = tops.norm_gelu_dwconv3x3(
        _t(args[0]).bfloat16(), *(_t(a) for a in args[1:]), groups_in=G, groups_out=G,
        pool_affine=(_t(c2), _t(o2)))
    assert pool.dtype == torch.float32 and pool.shape == (N, C)
    own = _jax_pool(_np(out), c2, o2)
    scale = np.abs(np.asarray(jax_gelu_abs(_np(out), c2, o2))).max()
    np.testing.assert_allclose(_np(pool), own, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(_np(pool), _jax_pool(ref, c2, o2), rtol=2e-3, atol=2e-3 * scale)


def jax_gelu_abs(out, c2, o2):
    """sum over the pixels of |gelu(out * c2 + o2)|: the scale of the pooled
    sum's rounding error."""
    import jax
    return jnp.abs(jax.nn.gelu(jnp.asarray(out, jnp.float32) * c2 + o2,
                               approximate=False)).sum(axis=(1, 2))


@pytest.mark.parametrize("shape", [(2, 9, 7, 12, 3), (1, 2, 2, 8, 1), (2, 16, 16, 32, 4)])
def test_norm_gelu_dwconv_pool_matches_jax_expression_fp32(rng, shape):
    """fp32: the pooled sum against the JAX expression on an independent
    output (exact-erf GELU, jnp reflect pad, lax depthwise conv): 1e-5 of
    sum|gelu| (fp32 sums in another order on outputs that agree to 1e-5)."""
    import jax
    N, H, W, C, G = shape
    x, mean, coef, scale, bias, w = _k4_case(rng, *shape)
    x = x + 1e-3 * rng.standard_normal(x.shape).astype(np.float32)
    c2 = rng.standard_normal(C).astype(np.float32)
    o2 = rng.standard_normal(C).astype(np.float32)
    mb = np.repeat(mean, C // G, -1)[:, None, None]
    cb = np.repeat(coef, C // G, -1)[:, None, None]
    h = jax.nn.gelu((jnp.asarray(x) - mb) * cb * scale + bias, approximate=False)
    hp = jnp.pad(h, [(0, 0), (1, 1), (1, 1), (0, 0)], mode="reflect")
    ref = np.asarray(jax.lax.conv_general_dilated(
        hp, jnp.asarray(w)[:, :, None, :], (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=C,
        precision=jax.lax.Precision.HIGHEST))
    out, s1, s2, pool = tops.norm_gelu_dwconv3x3(
        *(_t(a) for a in (x, mean, coef, scale, bias, w)), groups_in=G, groups_out=G,
        pool_affine=(_t(c2), _t(o2)))
    top = np.abs(ref).max()
    # |d gelu / d q| <= 1.13, so an output gap of 1e-5 top moves a term by
    # at most 1.13e-5 top |c2|
    slack = 1.13e-5 * top * np.abs(c2) * H * W
    np.testing.assert_allclose(_np(pool), _jax_pool(ref, c2, o2), rtol=0,
                               atol=float((1e-5 * np.asarray(jax_gelu_abs(ref, c2, o2)) + slack).max()))


def test_norm_gelu_dwconv_pool_is_of_the_rounded_output(rng):
    """The pooled sum takes the output after its cast to bf16, as the JAX
    body applies its reduction to the bf16 h2."""
    args = [_t(a) for a in _k4_case(rng, 2, 8, 8, 16, 4)]
    c2, o2 = _t(rng.standard_normal(16)).float(), _t(rng.standard_normal(16)).float()
    out, _, _, pool = tops.norm_gelu_dwconv3x3(args[0].bfloat16(), *args[1:],
                                               pool_affine=(c2, o2))
    want = torch.nn.functional.gelu(out.float() * c2 + o2).sum(dim=(1, 2))
    assert torch.equal(pool, want)
    exact, _, _, pool32 = tops.norm_gelu_dwconv3x3(args[0].bfloat16().float(), *args[1:],
                                                   pool_affine=(c2, o2))
    assert not torch.equal(pool, pool32)  # fp32 outputs: another sum
    np.testing.assert_allclose(_np(pool), _np(pool32), rtol=0,
                               atol=0.02 * float(exact.abs().max()) * 64)


@pytest.mark.parametrize("pooled", [False, True])
def test_norm_gelu_dwconv_without_stats(rng, pooled):
    """``do_stats=False``: zeros for the statistics, the same output (and
    pooled sum) to the bit; the tuple has four values only with
    ``pool_affine``."""
    args = [_t(a) for a in _k4_case(rng, 2, 6, 5, 16, 4)]
    kw = dict(pool_affine=(_t(rng.standard_normal(16)), _t(rng.standard_normal(16)))) if pooled else {}
    full = tops.norm_gelu_dwconv3x3(args[0].bfloat16(), *args[1:], **kw)
    bare = tops.norm_gelu_dwconv3x3(args[0].bfloat16(), *args[1:], do_stats=False, **kw)
    assert len(full) == len(bare) == (4 if pooled else 3)
    assert torch.equal(full[0], bare[0])
    assert full[1].any() and full[2].any()
    assert bare[1].shape == (2, 4) and not bare[1].any() and not bare[2].any()
    if pooled:
        assert torch.equal(full[3], bare[3])


def test_norm_gelu_dwconv_wrapper_rejects_bad_pool_affine():
    x = torch.zeros(2, 4, 4, 16)
    m, c, s, b = torch.zeros(2, 4), torch.ones(2, 4), torch.ones(16), torch.zeros(16)
    w = torch.zeros(3, 3, 16)
    with pytest.raises(ValueError, match=r"pool_affine\[0\]"):
        tops.norm_gelu_dwconv3x3(x, m, c, s, b, w, pool_affine=(torch.ones(8), torch.zeros(16)))
    with pytest.raises(ValueError, match=r"pool_affine\[1\]"):
        tops.norm_gelu_dwconv3x3(x, m, c, s, b, w, pool_affine=(torch.ones(16), torch.zeros(2, 16)))
    with pytest.raises(ValueError, match="scale, bias"):
        tops.norm_gelu_dwconv3x3(x, m, c, s, b, w, pool_affine=(torch.ones(16),))
    out = tops.norm_gelu_dwconv3x3(x, m, c, s, b, w,
                                   pool_affine=(torch.ones(16).double(), torch.zeros(16)))
    assert out[3].dtype == torch.float32  # the affine is taken as fp32


# ------------------------------------------------------- plain torch ops --

@pytest.mark.parametrize("hw,out", [((16, 16), (4, 4)), ((10, 7), (4, 3))])
def test_adaptive_max_pool2d(rng, hw, out):
    from uncrtaints_tpu.ops.pooling import adaptive_max_pool2d
    x = rng.standard_normal((2, 3, *hw, 5)).astype(np.float32)
    ref = adaptive_max_pool2d(jnp.asarray(x), out)
    got = tops.adaptive_max_pool2d(_t(x), out)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5, atol=0)


@pytest.mark.parametrize("hw,out", [((32, 32), (256, 256)), ((5, 7), (12, 20))])
def test_upsample_bilinear(rng, hw, out):
    from uncrtaints_tpu.ops.resize import upsample_bilinear
    x = rng.standard_normal((2, 3, *hw, 4)).astype(np.float32)
    ref = upsample_bilinear(jnp.asarray(x), out, hw_axes=(2, 3))
    got = tops.upsample_bilinear(_t(x), out)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw,out", [((32, 32), (256, 256)), ((5, 7), (12, 20)), ((8, 8), (8, 8))])
def test_upsample_bilinear_grad(rng, hw, out):
    """The port's own backward of the upsample (the interpolation matmuls'
    adjoint) against jax.vjp of the JAX package's upsample."""
    import jax
    from uncrtaints_tpu.ops.resize import upsample_bilinear
    x = rng.standard_normal((2, 3, *hw, 4)).astype(np.float32)
    g = rng.standard_normal((2, 3, *out, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: upsample_bilinear(a, out, hw_axes=(2, 3)), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = _t(x).requires_grad_()
    got, = torch.autograd.grad(tops.upsample_bilinear(xt, out), xt, _t(g))
    np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


def test_avg_pool2d(rng):
    from uncrtaints_tpu.ops.resize import avg_pool2d
    x = rng.standard_normal((2, 3, 8, 8, 4)).astype(np.float32)
    ref = avg_pool2d(jnp.asarray(x), 4, hw_axes=(2, 3))
    np.testing.assert_allclose(_np(tops.avg_pool2d(_t(x), 4)), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_ssim(rng):
    from uncrtaints_tpu.ops.ssim import ssim
    a = rng.random((2, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), 0, 1)
    for avg in (True, False):
        np.testing.assert_allclose(
            _np(tops.ssim(_t(a), _t(b), size_average=avg)),
            np.asarray(ssim(jnp.asarray(a), jnp.asarray(b), size_average=avg)),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_var", [True, False])
def test_img_metrics_batch(rng, with_var):
    from uncrtaints_tpu.metrics.image import img_metrics_batch as jmetrics
    from uncrtaints_tpu_torch.metrics import img_metrics_batch
    t = rng.random((2, 1, 24, 24, 13)).astype(np.float32)
    p = np.clip(t + 0.05 * rng.standard_normal(t.shape).astype(np.float32), 0, 1)
    v = rng.random(t.shape).astype(np.float32) if with_var else None
    ref = jmetrics(jnp.asarray(t), jnp.asarray(p),
                   var=None if v is None else jnp.asarray(v))
    got = img_metrics_batch(_t(t), _t(p), var=None if v is None else _t(v))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == (2,)
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("loss,covmode", [("MGNLL", "diag"), ("MGNLL", "iso"),
                                          ("GNLL", "uni"), ("l1", "diag"),
                                          ("l2", "diag")])
def test_losses(rng, loss, covmode):
    from uncrtaints_tpu.config import Config
    from uncrtaints_tpu.losses import calc_loss as jcalc, get_loss as jget
    from uncrtaints_tpu_torch.losses import calc_loss, get_loss
    cfg = Config(loss=loss, covmode=covmode)
    pred = rng.standard_normal((2, 1, 6, 5, 13)).astype(np.float32)
    targ = rng.standard_normal(pred.shape).astype(np.float32)
    nv = 1 if covmode == "iso" else 13
    # some variances below eps, some negative: the clamp is exercised
    var = (rng.random((2, 1, 6, 5, nv)) - 0.1).astype(np.float32)
    jl, jv = jcalc(jget(cfg), cfg, jnp.asarray(pred), jnp.asarray(targ),
                   var=jnp.asarray(var))
    tl, tv = calc_loss(get_loss(cfg), cfg, _t(pred), _t(targ), var=_t(var))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    if jv is None:
        assert tv is None
    else:
        np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-5)


@pytest.mark.parametrize("method", ["default", "resnet"])
def test_preprocess_device(rng, method):
    from uncrtaints_tpu.data import preprocess as jp
    from uncrtaints_tpu_torch.data import process_MS_device, process_SAR_device
    ms = (rng.random((2, 4, 4, 13)) * 12000 - 500).astype(np.float32)
    ms[0, 0, 0, 0] = np.nan
    sar = (rng.random((2, 4, 4, 2)) * -40 + 5).astype(np.float32)
    np.testing.assert_allclose(_np(process_MS_device(_t(ms), method)),
                               np.asarray(jp.process_MS_device(jnp.asarray(ms), method)),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(process_SAR_device(_t(sar), method)),
                               np.asarray(jp.process_SAR_device(jnp.asarray(sar), method)),
                               rtol=1e-6)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from uncrtaints_tpu_torch import _build
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
