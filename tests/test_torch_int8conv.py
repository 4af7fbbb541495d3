"""The int8 convolution's plain version (``ops.cuda.int8conv``) against the
JAX package's ``rcu_tpu.ops.quant.int8_conv`` (an XLA conv with int32
accumulation, run on the CPU): exactly equal int32 outputs for the 3x3
padding-1 sites, the fused up-conv's 4x4 padding-2 lhs-dilated conv, Cin
4, odd sides and a hypothesis fuzz over shapes; and the wrapper's checks.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rcu_tpu.ops import quant as jax_quant
from rcu_tpu_torch.ops.cuda import int8conv


def operands(seed, n, h, w, cin, cout, k, extreme=False):
    """NHWC int8 input and (Cout, k, k, Cin) int8 weights, seeded; with
    ``extreme`` every value is +-127."""
    rng = np.random.RandomState(seed)
    if extreme:
        x = np.where(rng.rand(n, h, w, cin) < 0.5, -127, 127)
        wq = np.where(rng.rand(cout, k, k, cin) < 0.5, -127, 127)
    else:
        x = rng.randint(-127, 128, (n, h, w, cin))
        wq = rng.randint(-127, 128, (cout, k, k, cin))
    return x.astype(np.int8), wq.astype(np.int8)


def jax_conv(x, wq, padding, dilation):
    """``int8_conv`` of the JAX package: weights HWIO."""
    return np.asarray(jax_quant.int8_conv(
        jnp.asarray(x), jnp.asarray(wq.transpose(1, 2, 3, 0)), padding,
        None if dilation == 1 else (dilation, dilation)))


def port_conv(x, wq, padding, dilation):
    return int8conv.int8_conv(torch.from_numpy(x), torch.from_numpy(wq),
                              padding, dilation)


@pytest.mark.parametrize("n,h,w,cin,cout,k,pad,dil,extreme", [
    (2, 12, 12, 32, 64, 3, 1, 1, False),
    (2, 45, 53, 4, 8, 3, 1, 1, False),  # Cin 4 (quantize_skip=0), odd sides
    (1, 9, 7, 16, 29, 3, 1, 1, False),  # Cout no multiple of 8
    (2, 6, 5, 24, 16, 4, 2, 2, False),  # the fused up-conv
    (1, 15, 15, 512, 4, 4, 2, 2, True),  # the widest sums of the U-Net
    (1, 5, 6, 7, 3, 1, 0, 1, False),  # 1x1
])
def test_plain_version_equals_jax(n, h, w, cin, cout, k, pad, dil, extreme):
    x, wq = operands(n * 31 + cin, n, h, w, cin, cout, k, extreme)
    want = jax_conv(x, wq, pad, dil)
    plain = int8conv.int8_conv.plain_calls
    got = port_conv(x, wq, pad, dil)
    assert int8conv.int8_conv.plain_calls == plain + 1
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert got.shape == want.shape == (
        n, int8conv.output_size(h, k, pad, dil),
        int8conv.output_size(w, k, pad, dil), cout)
    assert np.array_equal(got.numpy(), want)
    if dil == 2:  # spread by 2, padded by 2: the output doubles the input
        assert got.shape[1:3] == (2 * h, 2 * w)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 2), h=st.integers(1, 9), w=st.integers(1, 9),
       cin=st.integers(1, 40), cout=st.integers(1, 12),
       kernel=st.sampled_from([(3, 1, 1), (4, 2, 2), (1, 0, 1), (3, 1, 2)]),
       seed=st.integers(0, 2 ** 16))
def test_plain_version_equals_jax_fuzz(n, h, w, cin, cout, kernel, seed):
    k, pad, dil = kernel
    x, wq = operands(seed, n, h, w, cin, cout, k)
    assert np.array_equal(port_conv(x, wq, pad, dil).numpy(),
                          jax_conv(x, wq, pad, dil))


def test_dilate_spreads_with_zeros():
    x = torch.arange(1, 7, dtype=torch.int8).reshape(1, 2, 3, 1)
    got = int8conv.dilate(x, 2)[0, ..., 0]
    assert got.tolist() == [[1, 0, 2, 0, 3], [0, 0, 0, 0, 0], [4, 0, 5, 0, 6]]
    assert int8conv.dilate(x, 1) is x


@pytest.mark.parametrize("change,error", [
    (lambda x, w: (x.float(), w, 1), TypeError),
    (lambda x, w: (x, w[..., :3], 1), ValueError),  # Cin mismatch
    (lambda x, w: (x[0], w, 1), ValueError),  # not NHWC
    (lambda x, w: (x, w, 1, 3), ValueError),  # lhs dilation 3
])
def test_wrapper_refuses_what_the_kernel_does_not_take(change, error):
    x, wq = operands(0, 1, 4, 4, 4, 2, 3)
    with pytest.raises(error):
        int8conv.int8_conv(*change(torch.from_numpy(x), torch.from_numpy(wq)))


def test_wrapper_refuses_other_devices():
    x, wq = operands(0, 1, 4, 4, 4, 2, 3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        int8conv.int8_conv(torch.from_numpy(x).to("meta"),
                           torch.from_numpy(wq).to("meta"), 1)
