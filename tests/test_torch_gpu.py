"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`; each test asks the `cuda` fixture for the card and skips
without one, so every process collects the same tests. This file
imports neither jax nor kcmc_tpu, so it also runs where only the port's
dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from kcmc_tpu_torch import MotionCorrector
from kcmc_tpu_torch.ops import cuda_build, cuda_detect, cuda_patch, cuda_warp
from kcmc_tpu_torch.utils.synthetic import make_drift_stack

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stack(n=4, shape=(160, 192), seed=0):
    return make_drift_stack(n, shape, seed=seed)


def test_k1_matches_plain_bitwise(cuda):
    fr = torch.as_tensor(_stack().stack, device=cuda)
    before = cuda_build.launch_counts()["detect_response"]
    got = cuda_detect.detect_response(fr, smooth_sigma=2.0)
    want = cuda_detect.detect_response_plain(fr, smooth_sigma=2.0)
    assert cuda_build.launch_counts()["detect_response"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k2_matches_plain_bitwise(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    padded = torch.randn((3, 220, 250), device=cuda, generator=gen).to(torch.bfloat16)
    xy = torch.rand((3, 300, 2), device=cuda, generator=gen) * torch.tensor(
        [250.0 - 30, 220.0 - 30], device=cuda
    )
    got = cuda_patch.extract_blended(padded, xy.contiguous(), 28)
    want = cuda_patch.extract_blended_plain(padded, xy, 28)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_k3_matches_plain_bitwise(cuda):
    fr = torch.as_tensor(_stack(6).stack, device=cuda)
    M = torch.eye(3, device=cuda).repeat(6, 1, 1)
    M[:, 0, 2] = torch.tensor([3.25, -7.75, 140.3, 0.0, -128.0, 127.9])
    M[:, 1, 2] = torch.tensor([-1.5, 10.125, 2.0, -129.0, 127.5, -0.01])
    out, ok = cuda_warp.warp_translation(fr, M)
    want, want_ok = cuda_warp.warp_translation_plain(fr, M)
    assert torch.equal(ok, want_ok)
    assert torch.equal(out, want)


def test_slice_on_card_matches_cpu_route(cuda):
    data = _stack(8, (128, 128), seed=1)
    cuda_build.reset_launches()
    on_card = MotionCorrector(batch_size=4).correct(data.stack)
    assert cuda_build.launch_counts() == {
        "detect_response": 3, "extract_blended": 3, "warp_translation": 4,
    }
    on_cpu = MotionCorrector(device="cpu", batch_size=4).correct(data.stack)
    assert np.abs(on_card.transforms - on_cpu.transforms).max() <= 1e-4
    np.testing.assert_array_equal(
        on_card.diagnostics["n_inliers"], on_cpu.diagnostics["n_inliers"]
    )
