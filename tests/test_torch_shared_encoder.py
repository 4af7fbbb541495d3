"""Shared-encoder MC (``dropout_center < depth``): the dropout-free encoder
prefix runs once on the images and only the stochastic tail fans out over
the T samples. The prefix draws no random numbers, so every generator draws
at the same sites as in the full T*B forward, and the outputs equal it
bitwise on the CPU for batches of two or more images
(``tests/test_mc_shared_encoder.py`` holds the JAX package to the same)."""
import numpy as np
import pytest
import torch

from rcu_tpu.models import get_model as flax_get_model
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.eval import pipeline
from rcu_tpu_torch.eval.pipeline import sample_generators
from rcu_tpu_torch.models import FAST_DECODER_KWARGS, get_model
from tests.test_torch_unet import flax_net
from tests.test_torch_variants import port_net


class Unshared(torch.nn.Module):
    """The model with its encoder prefix hidden: mc_forward then runs the
    full T*B forward."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.dtype = model.dtype

    def forward(self, x, generators=None):
        return self.model(x, generators)


def center_model(depth=3, dropout_center=1, **options):
    params = dict(nb_classes=2, in_channels=3, depth=depth, start_filters=4,
                  dropout=0.3, dropout_center=dropout_center, **options)
    _, flax_params, stats = flax_net("unet", params, (24, 20), seed=depth)
    return port_net("unet", params, flax_params, stats)


@pytest.mark.parametrize("depth,dropout,dropout_center,shared", [
    (3, 0.3, 1, 2), (3, 0.3, None, 0), (3, None, 1, 0), (4, 0.05, 2, 2),
    (4, 0.05, 4, 0), (2, 0.3, 3, 0)])
def test_shared_block_count(depth, dropout, dropout_center, shared):
    """``tests/test_mc_shared_encoder.py``'s counts, and flax's for each."""
    params = dict(nb_classes=2, in_channels=3, depth=depth, start_filters=4,
                  dropout=dropout, dropout_center=dropout_center)
    assert get_model("unet", params).mc_shared_blocks == shared
    assert flax_get_model("unet", params).mc_shared_blocks == shared


@pytest.mark.parametrize("options", [{}, {"dtype": "bfloat16",
                                          **FAST_DECODER_KWARGS}])
@pytest.mark.parametrize("depth,dropout_center", [(3, 1), (3, 2), (2, 1)])
def test_mc_forward_shared_equals_full(options, depth, dropout_center):
    model = center_model(depth, dropout_center, **options)
    assert model.mc_shared_blocks == depth - dropout_center
    images = torch.from_numpy(np.random.RandomState(0).rand(2, 24, 20, 3)
                              .astype(np.float32))
    with torch.no_grad():
        shared = steps.mc_forward(model, images,
                                  sample_generators((3, 1), 0, 4, "cpu"))
        full = steps.mc_forward(Unshared(model), images,
                                sample_generators((3, 1), 0, 4, "cpu"))
    assert shared.shape == (4, 2, 24, 20, 2)
    assert torch.equal(shared, full)
    assert not torch.equal(shared[0], shared[1])  # the samples differ


def test_encode_shared_runs_the_prefix_once(monkeypatch):
    """The prefix sees the B images, the tail T*B rows."""
    model = center_model(3, 1)
    batch_sizes = []
    for block in model.down_blocks:
        block.register_forward_pre_hook(
            lambda module, args: batch_sizes.append(args[0].shape[0]))
    images = torch.rand(2, 24, 20, 3)
    with torch.no_grad():
        steps.mc_forward(model, images, sample_generators((0, 0), 0, 5, "cpu"))
    assert batch_sizes == [2, 2, 10]


def test_center_config_falls_through(monkeypatch):
    """The shipped center config (dropout_center == depth) has no prefix
    and runs the plain T*B forward."""
    model = center_model(depth=4, dropout_center=4)
    assert model.mc_shared_blocks == 0

    def refuse(*args):
        raise AssertionError("encode_shared ran for an empty prefix")

    monkeypatch.setattr(model, "encode_shared", refuse)
    with torch.no_grad():
        probs = steps.mc_forward(model, torch.rand(1, 32, 32, 3),
                                 sample_generators((0, 0), 0, 2, "cpu"))
    assert probs.shape == (2, 1, 32, 32, 2)


def test_volume_mc_eval_shared_equals_full():
    """The whole volume program, batch by batch, with the shared prefix and
    without: the same fg and entropy planes, bitwise."""
    model = center_model(3, 1)
    volume = torch.from_numpy(np.random.RandomState(1).rand(6, 24, 20, 3)
                              .astype(np.float32))
    shared = pipeline.infer("mc", model, {"images": volume}, 2, mc=3,
                            rng=(20, 0))
    full = pipeline.infer("mc", Unshared(model), {"images": volume}, 2, mc=3,
                          rng=(20, 0))
    for key in ("fg", "entropy", "prediction"):
        assert torch.equal(shared[key], full[key]), key


def test_one_image_batch_is_the_conv_s_rounding():
    """A ragged last batch of one image: the CPU's conv takes another
    algorithm for a batch of one than for the T rows of the full forward,
    so the prefix's outputs may differ in the last bits (the convolution's
    own rounding, not the protocol's); the same generators still draw the
    same masks."""
    model = center_model(3, 1)
    images = torch.from_numpy(np.random.RandomState(2).rand(1, 24, 20, 3)
                              .astype(np.float32))
    with torch.no_grad():
        shared = steps.mc_forward(model, images,
                                  sample_generators((3, 1), 0, 3, "cpu"))
        full = steps.mc_forward(Unshared(model), images,
                                sample_generators((3, 1), 0, 3, "cpu"))
    torch.testing.assert_close(shared, full, rtol=1e-6, atol=1e-6)
    assert not torch.equal(shared[0], shared[1])
