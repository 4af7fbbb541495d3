"""The int8 conv site with its epilogue (``ops.cuda.int8conv``) on the CPU.

- ``int8_conv_dequant_reference`` (the plain version of the fused kernel)
  is bitwise flax's ``_QuantConv`` and the int8 ``_SplitInputConv`` given
  the JAX package's own quantized operands: in f32 and bf16, BN-folded
  (``_compensated_bias_add``) and not, the fused up-conv at even and odd
  sides.
- A numpy model of the kernel's index math (tiles of 8 x 16 pixels, the
  taps of each output phase, a box a tap and channel step with TMA's zero
  fill, the masked store) gives int32 equal to JAX's lhs-dilated
  ``int8_conv``: the phase split of the fused up-conv runs 4 taps an
  output and loses nothing.
- The wrapper refuses what the kernel does not take, pads narrow or
  misaligned inputs for it, counts one plain conv a term on the CPU, and
  the model's site keeps its memory format.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcu_tpu.models.unet import _UPSAMPLE_FOLD, _QuantConv, _SplitInputConv
from rcu_tpu.ops import quant as jax_quant
from rcu_tpu_torch.models.unet import int8_conv_out
from rcu_tpu_torch.ops.cuda import int8conv

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def bits(x):
    """f32 bit pattern (bf16 widens exactly): equality is bitwise."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))
    return x.float().contiguous().view(torch.int32)


def to_torch(a, dtype):
    """A JAX array in ``dtype`` as a torch tensor of the same values."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))) \
        .to(dtype)


def jax_term(x, kernel, a_scale, j_dtype, t_dtype, fold=False):
    """One input of a site quantized as flax quantizes it, in the port's
    layouts: (int8 NHWC input, (O, kh, kw, I) int8 weights, the scale
    ``(w_scale * a_scale).astype(compute)``)."""
    kf = jnp.asarray(kernel).astype(jnp.float32)
    if fold:
        f = jnp.asarray(_UPSAMPLE_FOLD, jnp.float32)
        kf = jnp.einsum("ai,bj,ijco->abco", f, f, kf)
    k_q, w_scale = jax_quant.quantize_weight(kf)
    x_q = jax_quant.quantize_activation(jnp.asarray(x).astype(j_dtype),
                                        a_scale)
    return (torch.from_numpy(np.array(x_q)),
            torch.from_numpy(np.asarray(k_q).transpose(3, 0, 1, 2).copy()),
            to_torch((w_scale * a_scale).astype(j_dtype), t_dtype))


def jax_bias(bias, j_dtype, t_dtype, folded):
    """The bias terms as the flax site adds them: the compute-dtype bias,
    or a folded bf16 site's ``hi`` and ``lo`` (``_compensated_bias_add``),
    or a folded f32 site's f32 bias."""
    bias = jnp.asarray(bias)
    if folded and j_dtype != jnp.float32:
        hi = bias.astype(j_dtype)
        lo = (bias - hi.astype(jnp.float32)).astype(j_dtype)
        return to_torch(hi, t_dtype), to_torch(lo, t_dtype)
    return to_torch(bias.astype(j_dtype), t_dtype), None


def site_params(seed, cin, cout):
    rng = np.random.RandomState(seed)
    kernel = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    return rng, {"kernel": kernel,
                 "bias": (rng.randn(cout) * 0.3).astype(np.float32)}


def precast(params, j_dtype, folded):
    """The params as the JAX direct eval holds them (bf16 kernel; the bias
    kept f32 in a folded model)."""
    return {"kernel": np.asarray(jnp.asarray(params["kernel"]).astype(j_dtype)
                                 .astype(jnp.float32)).astype(j_dtype)
            if j_dtype != jnp.float32 else params["kernel"],
            "bias": params["bias"] if folded or j_dtype == jnp.float32
            else jnp.asarray(params["bias"]).astype(j_dtype)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("folded", [False, True])
def test_plain_site_is_flax_quant_conv(dtype, folded):
    t_dtype, j_dtype = DTYPES[dtype]
    rng, params = site_params(21, 24, 40)
    x = (rng.randn(2, 9, 11, 24) * 2).astype(np.float32)
    a_scale = float(np.abs(x).max()) * 1.1 / 127 * 0.8  # some saturate
    jp = precast(params, j_dtype, folded)
    want = _QuantConv(40, dtype=j_dtype, f32_bias=folded).apply(
        {"params": jp}, jnp.asarray(x).astype(j_dtype), a_scale=a_scale)
    term = jax_term(x, jp["kernel"], a_scale, j_dtype, t_dtype)
    bias, lo = jax_bias(jp["bias"], j_dtype, t_dtype, folded)
    got = int8conv.int8_conv_dequant_reference([term], bias, 1, 1, lo)
    assert got.dtype == t_dtype and tuple(got.shape) == want.shape
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("folded", [False, True])
def test_split_pair_is_flax_split_input_conv(dtype, folded):
    """Each half quantized on its own, the two dequantized products added,
    then the bias: ``ta + tb`` rounds once before the bias."""
    t_dtype, j_dtype = DTYPES[dtype]
    rng, params = site_params(22, 32, 16)
    a = (rng.randn(2, 7, 6, 16) * 2).astype(np.float32)
    b = (rng.randn(2, 7, 6, 16) * 0.3).astype(np.float32)
    sa = float(np.abs(a).max()) * 1.1 / 127
    sb = float(np.abs(b).max()) * 1.1 / 127
    jp = precast(params, j_dtype, folded)
    want = _SplitInputConv(16, dtype=j_dtype, f32_bias=folded).apply(
        {"params": jp}, jnp.asarray(a).astype(j_dtype),
        jnp.asarray(b).astype(j_dtype), a_scale=sa, b_scale=sb)
    kernel = jnp.asarray(jp["kernel"])
    terms = [jax_term(a, kernel[:, :, :16], sa, j_dtype, t_dtype),
             jax_term(b, kernel[:, :, 16:], sb, j_dtype, t_dtype)]
    bias, lo = jax_bias(jp["bias"], j_dtype, t_dtype, folded)
    got = int8conv.int8_conv_dequant_reference(terms, bias, 1, 1, lo)
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hw", [(8, 8), (5, 7)])
def test_fused_up_conv_is_flax_quant_conv(dtype, hw):
    """The 3x3 kernel folded to 4x4 in f32, quantized, the lhs-dilated conv
    with padding 2: the output doubles the input, even and odd sides."""
    t_dtype, j_dtype = DTYPES[dtype]
    rng, params = site_params(hw[1], 32, 16)
    x = np.abs(rng.randn(2, *hw, 32)).astype(np.float32)  # after a ReLU
    a_scale = float(x.max()) * 1.1 / 127
    jp = precast(params, j_dtype, False)
    want = _QuantConv(16, dtype=j_dtype, fold_upsample=True).apply(
        {"params": jp}, jnp.asarray(x).astype(j_dtype), a_scale=a_scale)
    term = jax_term(x, jp["kernel"], a_scale, j_dtype, t_dtype, fold=True)
    bias, _ = jax_bias(jp["bias"], j_dtype, t_dtype, False)
    got = int8conv.int8_conv_dequant_reference([term], bias, 2, 2)
    assert tuple(got.shape) == want.shape == (2, 2 * hw[0], 2 * hw[1], 16)
    assert torch.equal(bits(got), bits(want))


# ----------------------------------------------- the kernel's index math

TILE_H, TILE_W, GRAIN, MIN_CIN = 8, 16, 16, 32  # csrc/int8conv.cu


def kernel_model(x, w, pad, dil):
    """int8conv.cu's int32 result, block by block, in numpy: the wrapper's
    channel padding (to a multiple of 16, 32 at least); per block (image,
    phase, tile row, tile column, output-channel block) the phase's taps
    ky0, ky0 + dil, ... with ky0 = (pad - py) & 1 under dil 2; per tap and
    step of BK channels (32 where Cin <= 32, 64 where Cin <= 64, else 128)
    one box of the input, 8 rows x 16 columns shifted by the tap, read with
    zeros outside the tensor, times the tap's weight box; the store of the
    pixels inside the output, at stride dil."""
    n, h, wd, cin = x.shape
    cout, kh, kw, _ = w.shape
    extra = max(MIN_CIN, -(-cin // GRAIN) * GRAIN) - cin
    x = np.pad(x, ((0, 0),) * 3 + ((0, extra),)).astype(np.int64)
    w = np.pad(w, ((0, 0),) * 3 + ((0, extra),)).astype(np.int64)
    cin += extra
    bk = 32 if cin <= 32 else 64 if cin <= 64 else 128
    sh = dil - 1
    hout = (h - 1) * dil + 1 + 2 * pad - kh + 1
    wout = (wd - 1) * dil + 1 + 2 * pad - kw + 1
    tiles_h = -(-(-(-hout // dil)) // TILE_H)
    tiles_w = -(-(-(-wout // dil)) // TILE_W)
    bn = 64 if cout <= 64 else 128
    taps_w = w.reshape(cout, kh * kw, cin)

    def box(img, y0, x0, c0):  # TMA: zeros outside the tensor
        out = np.zeros((TILE_H, TILE_W, bk), np.int64)
        ys = slice(max(y0, 0), min(y0 + TILE_H, h))
        xs = slice(max(x0, 0), min(x0 + TILE_W, wd))
        c1 = min(c0 + bk, cin)
        if ys.start < ys.stop and xs.start < xs.stop:
            out[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0,
                :c1 - c0] = x[img, ys, xs, c0:c1]
        return out

    def weights(c0, tap, n0):
        out = np.zeros((bn, bk), np.int64)
        part = taps_w[n0:n0 + bn, tap, c0:c0 + bk]
        out[:part.shape[0], :part.shape[1]] = part
        return out

    y = np.full((n, hout, wout, cout), -1, np.int64)  # every pixel written
    for img in range(n):
        for phase in range(dil * dil):
            py, px = phase >> 1, phase & 1
            ky0 = (pad - py) & 1 if sh else 0
            kx0 = (pad - px) & 1 if sh else 0
            nty, ntx = (kh - ky0 + sh) >> sh, (kw - kx0 + sh) >> sh
            for th in range(tiles_h):
                for tw in range(tiles_w):
                    i0, j0 = th * TILE_H, tw * TILE_W
                    for n0 in range(0, cout, bn):
                        acc = np.zeros((TILE_H, TILE_W, bn), np.int64)
                        for tap in range(nty * ntx):
                            ky = ky0 + ((tap // ntx) << sh)
                            kx = kx0 + ((tap % ntx) << sh)
                            y0 = i0 + ((py + ky - pad) >> sh)
                            x0 = j0 + ((px + kx - pad) >> sh)
                            for c0 in range(0, cin, bk):
                                acc += box(img, y0, x0, c0) \
                                    @ weights(c0, ky * kw + kx, n0).T
                        for r in range(TILE_H):
                            for col in range(TILE_W):
                                oy = ((i0 + r) << sh) + py
                                ox = ((j0 + col) << sh) + px
                                if oy < hout and ox < wout:
                                    m = min(bn, cout - n0)
                                    y[img, oy, ox, n0:n0 + m] = acc[r, col, :m]
    return y.astype(np.int32)


@pytest.mark.parametrize("n,h,w,cin,cout,k,pad,dil", [
    (2, 6, 5, 24, 16, 4, 2, 2),  # the fused up-conv, Cin padded to 32
    (1, 23, 27, 128, 64, 4, 2, 2),  # odd sides: the edge phases read zeros
    (1, 15, 15, 512, 32, 4, 2, 2),  # the bottom's up-conv width, 8 chunks
    (2, 12, 12, 64, 64, 3, 1, 1),  # a 3x3 site
    (1, 9, 20, 32, 200, 3, 1, 1),  # two 128-channel blocks, a ragged one
    (1, 9, 7, 16, 8, 3, 1, 2),  # dilated 3x3: phases of 1 and 2 taps
    (2, 5, 6, 16, 3, 1, 0, 2),  # dilated 1x1: phases with no tap
])
def test_kernel_index_math_equals_jax(n, h, w, cin, cout, k, pad, dil):
    rng = np.random.RandomState(n * h + cin)
    x = rng.randint(-127, 128, (n, h, w, cin)).astype(np.int8)
    wq = rng.randint(-127, 128, (cout, k, k, cin)).astype(np.int8)
    want = np.asarray(jax_quant.int8_conv(
        jnp.asarray(x), jnp.asarray(wq.transpose(1, 2, 3, 0)), pad,
        None if dil == 1 else (dil, dil)))
    assert np.array_equal(kernel_model(x, wq, pad, dil), want)


def test_fused_up_conv_runs_four_taps_an_output():
    """Under lhs dilation 2 and padding 2, each output phase of the 4x4
    kernel keeps 2 taps a side, and the four phases use each tap once."""
    seen = []
    for py in (0, 1):
        ky0 = (2 - py) & 1
        seen.append([ky0 + 2 * t for t in range((4 - ky0 + 1) >> 1)])
    assert [len(t) for t in seen] == [2, 2]
    assert sorted(sum(seen, [])) == [0, 1, 2, 3]


# ---------------------------------------------------------------- wrapper

def small_terms(dtype=torch.bfloat16, pair=False, cin=8, cout=6):
    rng = np.random.RandomState(cin + cout)
    terms = []
    for _ in range(2 if pair else 1):
        terms.append((
            torch.from_numpy(rng.randint(-127, 128, (1, 5, 4, cin))
                             .astype(np.int8)),
            torch.from_numpy(rng.randint(-127, 128, (cout, 3, 3, cin))
                             .astype(np.int8)),
            torch.from_numpy(rng.uniform(1e-4, 1e-2, cout)
                             .astype(np.float32)).to(dtype)))
    return terms, torch.from_numpy(rng.randn(cout).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("change,error,match", [
    (lambda t, b: ([], b), ValueError, "one input or a split pair"),
    (lambda t, b: (t * 3, b), ValueError, "one input or a split pair"),
    (lambda t, b: ([(x, w, s.half()) for x, w, s in t], b.half()), TypeError,
     "compute dtype"),
    (lambda t, b: ([(x, w, s[:-1]) for x, w, s in t], b), ValueError, "scale"),
    (lambda t, b: (t, b.float()), ValueError, "bias"),
    (lambda t, b: ([(x.float(), w, s) for x, w, s in t], b), TypeError,
     "int8"),
    (lambda t, b: ([t[0], (t[1][0][:, :3], t[1][1], t[1][2])], b), ValueError,
     "differ"),
    (lambda t, b: ([(x.to("meta"), w.to("meta"), s.to("meta"))
                    for x, w, s in t], b.to("meta")), ValueError,
     "cuda or cpu"),
])
def test_dequant_refuses_what_the_kernel_does_not_take(change, error, match):
    terms, bias = small_terms(pair=True)
    with pytest.raises(error, match=match):
        int8conv.int8_conv_dequant(*change(terms, bias), 1)


def test_dequant_refuses_lo_of_another_width():
    terms, bias = small_terms()
    with pytest.raises(ValueError, match="lo"):
        int8conv.int8_conv_dequant(terms, bias, 1, lo=bias[:2])


def test_dequant_refuses_lo_in_f32():
    """``lo`` is a bf16 folded site's second bias term; the kernel's f32
    epilogue has none, so an f32 ``lo`` is refused, not dropped."""
    terms, bias = small_terms(dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16 only"):
        int8conv.int8_conv_dequant(terms, bias, 1, lo=torch.zeros_like(bias))


def test_dequant_counts_a_plain_conv_a_term_on_the_cpu():
    terms, bias = small_terms(pair=True)
    plain, launches = int8conv.int8_conv.plain_calls, int8conv.int8_conv.launches
    got = int8conv.int8_conv_dequant(terms, bias, 1)
    assert int8conv.int8_conv.plain_calls == plain + 2
    assert int8conv.int8_conv.launches == launches
    want = int8conv.int8_conv_dequant_reference(terms, bias, 1)
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("cin,offset", [(5, 0), (16, 0), (32, 1), (40, 3),
                                        (64, 0)])
def test_kernel_operands_pad_and_align(cin, offset):
    """What the kernel reads: Cin a multiple of 16 and at least 32 (zeros
    appended, so the sums are the same) and 16-byte aligned (a view off the
    grain copied); an aligned input of such a width is used as it is."""
    terms, _ = small_terms(cin=cin)
    x, wq, _ = terms[0]
    if offset:
        shifted = torch.empty(x.numel() + offset, dtype=torch.int8)[offset:]
        x = shifted.view(x.shape).copy_(x)
    got_x, got_w = int8conv._kernel_operands(x, wq)
    assert got_x.shape[3] % 16 == 0 and got_x.shape[3] >= 32
    assert got_w.shape[3] == got_x.shape[3]
    assert got_x.data_ptr() % 16 == 0 and got_w.data_ptr() % 16 == 0
    assert (got_x is x) == (cin % 16 == 0 and cin >= 32 and not offset)
    assert torch.equal(got_x[..., :cin], x) and not got_x[..., cin:].any()
    assert torch.equal(int8conv.int8_conv_reference(got_x, got_w, 1),
                       int8conv.int8_conv_reference(x, wq, 1))


def test_kernel_operands_refuse_a_non_contiguous_input():
    terms, _ = small_terms(cin=16)
    x, wq, _ = terms[0]
    with pytest.raises(ValueError, match="contiguous"):
        int8conv._kernel_operands(x.permute(0, 2, 1, 3), wq)


@pytest.mark.parametrize("dtype,layout", [
    (torch.bfloat16, torch.channels_last), (torch.float32,
                                            torch.contiguous_format)])
def test_model_site_is_one_dequant_call(dtype, layout):
    """``int8_conv_out`` quantizes its input, calls ``int8_conv_dequant``
    once with the scale ``(w_scale * f32(a)).to(dtype)`` and the bias, and
    returns its NHWC output in the memory format of its input."""
    from rcu_tpu_torch.models.unet import int8_weights, quantize_nhwc
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(16, 24, 3, padding=1).to(dtype)
    x = torch.randn(2, 16, 7, 9).to(dtype).contiguous(memory_format=layout)
    got = int8_conv_out([x], [0.03], conv)
    assert got.dtype == dtype and got.is_contiguous(memory_format=layout)
    ((w_q, w_scale),) = int8_weights(conv, [16])
    scale = (w_scale * torch.tensor(0.03, dtype=torch.float32)).to(dtype)
    want = int8conv.int8_conv_dequant_reference(
        [(quantize_nhwc(x, 0.03), w_q, scale)], conv.bias.to(dtype), 1)
    assert torch.equal(bits(got.permute(0, 2, 3, 1)), bits(want))
