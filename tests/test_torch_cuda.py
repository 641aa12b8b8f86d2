"""K1 on the card against its plain version. Needs a CUDA device and skips
without one. It imports neither jax nor the JAX package, so it also runs
where only torch is installed:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerances: f32 ``1e-6 * nsteps``, bf16 one ulp at values below 4; the two
differ only in summation order and nvcc's FMA contraction."""

import numpy as np
import pytest
import torch

from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import fused_stencil as fs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 1), (torch.float32, 8),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS])
def test_kernel_matches_plain_on_the_card(dtype, ns, offs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    v = np.random.default_rng(42).uniform(0.5, 2.0, (256, 512))
    x = torch.from_numpy(v).to(dev, dtype)
    before = fs.launches()
    got = fs.pallas_dense_step(x, 0.13, offs, nsteps=ns)
    assert fs.launches() == before + 1
    want = fs.dense_step_plain(x, 0.13, offs, ns)
    tol = 1e-6 * ns if dtype == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # out of place: the input is untouched
    torch.testing.assert_close(x, torch.from_numpy(v).to(dev, dtype),
                               rtol=0, atol=0)
