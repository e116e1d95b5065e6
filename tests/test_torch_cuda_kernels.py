"""Kernel K1 (the centered Gram) on a CUDA card, against its plain version.

These tests need the card: they are marked ``cuda`` and skip without one.
They import nothing of JAX, so on a machine with a card and no JAX they
run without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerance: the kernel and the plain version (cuBLAS, TF32 off) sum in
different orders, so both are held against a float64 Gram of the same
input, relative to max |C|: 1e-5 for float32 at these sizes, 1e-12 for
float64.
"""

import pytest
import torch

from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.ops.kernels import covariance as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    port_device.use_ieee_fp32_matmul()
    return torch.device("cuda")


def _rel_err(got: torch.Tensor, x: torch.Tensor, mean: torch.Tensor) -> float:
    b = x.double() - mean.double()
    ref = b.T @ b
    return ((got.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-300)).item()


@pytest.mark.parametrize(
    "n,d,dtype,tol",
    [
        (1, 1, torch.float32, 1e-5),
        (31, 65, torch.float32, 1e-5),
        (4099, 130, torch.float32, 1e-5),
        (2048, 256, torch.float64, 1e-12),
        (333, 70, torch.float64, 1e-12),
    ],
)
def test_kernel_matches_float64_gram(cuda, n, d, dtype, tol):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n * 1000 + d)
    x = torch.randn((n, d), generator=gen, device=cuda, dtype=dtype) + 2.0
    mean = x.mean(dim=0)
    before = k1.launches
    got = k1.centered_gram_cuda(x, mean)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert got.shape == (d, d) and got.dtype == dtype
    assert torch.equal(got, got.T)
    assert _rel_err(got, x, mean) <= tol
    assert _rel_err(k1.centered_gram_plain(x, mean), x, mean) <= tol


def test_kernel_is_deterministic(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    x = torch.randn((50_000, 200), generator=gen, device=cuda)
    mean = x.mean(dim=0)
    assert torch.equal(k1.centered_gram_cuda(x, mean), k1.centered_gram_cuda(x, mean))


def test_empty_rows_give_zeros(cuda):
    x = torch.zeros((0, 9), device=cuda)
    out = k1.centered_gram_cuda(x, torch.zeros(9, device=cuda))
    assert torch.equal(out, torch.zeros((9, 9), device=cuda))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.randn((64, 32), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k1.centered_gram_cuda(x.T, torch.zeros(64, device=cuda))
    with pytest.raises(TypeError, match="float32 or float64"):
        k1.centered_gram_cuda(x.half(), torch.zeros(32, device=cuda).half())
    with pytest.raises(ValueError, match="is on"):
        k1.centered_gram_cuda(x, torch.zeros(32))
