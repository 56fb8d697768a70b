"""The port's DoG (plain version here; the CUDA kernel on a card) against
the JAX package's Pallas kernel (interpret mode) and masked filter."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feabas_tpu.ops import filters as jfilters
from feabas_tpu.ops.pallas_kernels import dog_filter as pallas_dog
from feabas_tpu_torch import build
from feabas_tpu_torch.ops import dog
from feabas_tpu_torch.ops.filters import masked_dog_filter

# f32 blur sums in a different order: the tolerance of test_pallas.py
ATOL = 1e-3


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_plain_dog_matches_pallas(rng, dtype):
    stack = rng.integers(0, 255, (4, 64, 128)).astype(dtype)
    want = np.asarray(pallas_dog(jnp.asarray(stack), sigma=2.5, interpret=True))
    got = dog.dog_filter(torch.from_numpy(stack), 2.5)
    assert got.dtype == torch.float32 and got.shape == (4, 64, 128)
    assert np.abs(got.numpy() - want).max() < ATOL


@pytest.mark.parametrize('signed', [True, False])
def test_masked_dog_matches_jax(rng, signed):
    img = (rng.random((1, 96, 160)) * 255).astype(np.float32)
    mask = np.ones((1, 96, 160), np.float32)
    mask[:, 70:, :] = 0
    mask[:, :, 130:] = 0
    want = np.asarray(jfilters.masked_dog_filter(img, 2.5, mask=mask,
                                                 signed=signed))
    got = masked_dog_filter(torch.from_numpy(img), 2.5,
                            mask=torch.from_numpy(mask), signed=signed)
    assert np.abs(got.numpy() - want).max() < ATOL


def test_plain_dog_matches_pallas_where_the_halo_exceeds_the_plane(rng):
    """(4, 24, 24) at sigma 3.5: 4r = 56 > 24, so every window clamps."""
    stack = (rng.random((4, 24, 24)) * 255).astype(np.float32)
    want = np.asarray(pallas_dog(jnp.asarray(stack), sigma=3.5, interpret=True))
    got = dog.dog_filter(torch.from_numpy(stack), 3.5)
    assert np.abs(got.numpy() - want).max() < ATOL


def test_kernel_refuses_a_radius_beyond_its_maximum():
    taps, radius = dog._taps(dog.MAX_RADIUS / 4.0)
    assert radius == dog.MAX_RADIUS and taps.size == 2 * radius + 1
    with pytest.raises(ValueError, match='exceeds'):
        dog._taps((dog.MAX_RADIUS + 1) / 4.0)


def test_plain_blur_matches_jax(rng):
    img = (rng.random((3, 40, 56)) * 255).astype(np.float32)
    want = np.asarray(jfilters.gaussian_blur(jnp.asarray(img), 3.5))
    got = dog.gaussian_blur(torch.from_numpy(img), 3.5)
    assert np.abs(got.numpy() - want).max() < ATOL


def test_kernel_wrapper_checks_its_input():
    with pytest.raises(ValueError):
        dog._check(torch.zeros((2, 8, 8)), (torch.float32,))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, 'which', lambda name: None)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setattr(build, 'BUILD_DIR', str(tmp_path / '_build'))
    with pytest.raises(RuntimeError, match='nvcc'):
        build.build('dog_filter')


# phase-3 shapes of chip_smoke.py: both code paths of the kernel (whole
# planes, halo tiles), their edges, and stacks the stitch path launches
CARD_SHAPES = [(1, 1, 1), (1, 3, 700), (1, 4000, 3), (4, 24, 24),
               (2, 129, 130), (2, 512, 512), (1, 1664, 384),
               (6, 4096, 4096), (64, 128, 128), (1, 224, 2016),
               (1, 1504, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize('sigma', [1.25, 2.5, 3.5, 4.0, 4.95])
@pytest.mark.parametrize('shape', CARD_SHAPES)
def test_kernel_matches_plain_on_card(shape, sigma):
    """DoG (u8 and f32) and blur (f32, the type its callers pass) against
    the plain version on the card, each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    from feabas_tpu_torch import device
    g = torch.Generator(device='cuda').manual_seed(0)
    x = torch.rand(shape, generator=g, device='cuda') * 255
    for dtype in (torch.uint8, torch.float32):
        xt = x.to(dtype)
        before = device.launch_counts()['dog_filter']
        got = dog.dog_filter(xt, sigma)
        torch.cuda.synchronize()
        assert device.launch_counts()['dog_filter'] == before + 1
        assert got.shape == shape and got.dtype == torch.float32
        assert float((got - dog.dog_filter_plain(xt, sigma)).abs().max()) < ATOL
    before = device.launch_counts()['gaussian_blur']
    blur = dog.gaussian_blur(x, sigma)
    torch.cuda.synchronize()
    assert device.launch_counts()['gaussian_blur'] == before + 1
    assert float((blur - dog.gaussian_blur_plain(x, sigma)).abs().max()) < ATOL
