"""The conv flow layers (GatedConv2d, GatedConvTranspose2d, build_pixelcnn_mask,
MaskedConv2d): the port (NCHW) against cfnerf_tpu's flax modules (NHWC) on
the same weights and seeded inputs.  The tests transpose: inputs NHWC ->
NCHW, conv kernels HWIO -> OIHW (Conv2d) or HWIO -> IOHW
(ConvTranspose2d), outputs back.

Tolerance rtol = atol = 1e-5: the same f32 products, summed over the
window and the channels in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.flows import conv_layers as jconv
from cfnerf_torch.flows import conv_layers as tconv
from tests.test_torch_common import to_np

TOL = dict(rtol=1e-5, atol=1e-5)


def _nhwc(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _to_nhwc(t):
    return to_np(t).transpose(0, 2, 3, 1)


def _load_conv(conv, kernel, bias, transpose=False):
    """A flax HWIO kernel into an nn.Conv2d (OIHW) or nn.ConvTranspose2d
    (IOHW: torch's transposed conv flips the window itself)."""
    k = np.asarray(kernel)
    w = k.transpose(2, 3, 0, 1) if transpose else k.transpose(3, 2, 0, 1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
        conv.bias.copy_(torch.from_numpy(np.asarray(bias)))


@pytest.mark.parametrize("kernel,strides,padding,dilation,act", [
    ((3, 3), (1, 1), (1, 1), (1, 1), None),
    ((3, 3), (2, 2), (1, 1), (1, 1), "elu"),
    ((5, 3), (1, 2), (2, 0), (1, 1), None),
    ((3, 3), (1, 1), (2, 2), (2, 2), "elu"),
], ids=["same", "stride2_elu", "rect", "dilated_elu"])
def test_gated_conv2d_matches_jax(kernel, strides, padding, dilation, act):
    x = _nhwc((2, 9, 11, 4), seed=0)
    jact = jax.nn.elu if act else None
    tact = torch.nn.functional.elu if act else None
    jmod = jconv.GatedConv2d(6, kernel, strides, padding, dilation, jact)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tmod = tconv.GatedConv2d(4, 6, kernel, strides, padding, dilation, tact)
    for name in ("h", "g"):
        _load_conv(getattr(tmod, name), params[name]["kernel"], params[name]["bias"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _to_nhwc(tmod(_to_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kernel,strides,padding,output_padding,dilation", [
    ((3, 3), (1, 1), (0, 0), (0, 0), (1, 1)),
    ((3, 3), (2, 2), (1, 1), (1, 1), (1, 1)),
    ((4, 3), (2, 1), (1, 0), (0, 0), (1, 2)),
], ids=["plain", "upsample2", "rect_dilated"])
def test_gated_conv_transpose2d_matches_jax(kernel, strides, padding, output_padding,
                                            dilation):
    """torch ConvTranspose2d geometry: (in - 1) s - 2 p + d (k - 1) + op + 1."""
    x = _nhwc((2, 5, 6, 3), seed=1)
    jmod = jconv.GatedConvTranspose2d(4, kernel, strides, padding, output_padding, dilation)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    tmod = tconv.GatedConvTranspose2d(3, 4, kernel, strides, padding, output_padding,
                                      dilation)
    for name in ("h", "g"):
        _load_conv(getattr(tmod, name), params[f"{name}_kernel"], params[f"{name}_bias"],
                   transpose=True)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _to_nhwc(tmod(_to_nchw(x)))
    H = (5 - 1) * strides[0] - 2 * padding[0] + dilation[0] * (kernel[0] - 1) \
        + output_padding[0] + 1
    assert got.shape == want.shape and got.shape[1] == H
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_in,n_out,size,diagonal_zeros", [
    (4, 8, (3, 3), False), (4, 8, (3, 3), True), (8, 4, (3, 3), True),
    (6, 6, (5, 5), False), (3, 3, (1, 1), True),
])
def test_pixelcnn_mask_matches_jax(n_in, n_out, size, diagonal_zeros):
    np.testing.assert_array_equal(
        tconv.build_pixelcnn_mask(n_in, n_out, size, diagonal_zeros),
        jconv.build_pixelcnn_mask(n_in, n_out, size, diagonal_zeros))


def test_pixelcnn_mask_refuses_channels_that_do_not_divide():
    with pytest.raises(ValueError, match="must divide"):
        tconv.build_pixelcnn_mask(4, 6)


@pytest.mark.parametrize("n_in,n_out,size,diagonal_zeros,use_bias", [
    (4, 8, (3, 3), False, True), (4, 8, (3, 3), True, True), (8, 4, (3, 3), True, False),
    (6, 6, (3, 3), True, True), (4, 4, (5, 5), False, True),
], ids=["widen", "widen_strict", "narrow_nobias", "square_strict", "k5_pad1"])
def test_masked_conv2d_matches_jax(n_in, n_out, size, diagonal_zeros, use_bias):
    """Padded (1, 1) whatever the kernel size, as the reference does: a 5x5
    kernel shrinks the image by 2 each side."""
    x = _nhwc((2, 7, 8, n_in), seed=2)
    jmod = jconv.MaskedConv2d(n_out, size, diagonal_zeros, use_bias)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    if use_bias:  # off its zero init, so the bias is exercised
        params["bias"] = np.random.RandomState(3).randn(n_out).astype(np.float32)
    tmod = tconv.MaskedConv2d(n_in, n_out, size, diagonal_zeros, use_bias)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            params["kernel"].transpose(3, 2, 0, 1))))
        if use_bias:
            tmod.bias.copy_(torch.from_numpy(params["bias"]))
    assert (tmod.bias is None) == (not use_bias)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _to_nhwc(tmod(_to_nchw(x)))
    assert got.shape == want.shape == (2, 7 + 2 - size[0] + 1, 8 + 2 - size[1] + 1, n_out)
    np.testing.assert_allclose(got, want, **TOL)
    # the mask is a buffer outside the state dict; the weight is unmasked
    assert set(tmod.state_dict()) == ({"weight", "bias"} if use_bias else {"weight"})
