"""The port on a CUDA GPU: each hand-written kernel against its plain
version, the wrappers' input checks, and the serving path with
``impl="kernel"`` against ``impl="ref"``.

Every test here needs the card (``cuda`` marker) and skips without one.
This file imports no JAX, so on a GPU machine without JAX it runs with::

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import serving
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_cuda_kernels_match_plain_versions(cuda_device):
    """Both kernels against their plain versions at decode, prefill-chunk and
    ragged shapes (fp32 1e-4, bf16 3e-2); the launch counters move."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n_flash, n_rms = flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        for B, Sq, Sk in ((8, 1, 1025), (1, 256, 1280), (2, 37, 37)):
            q, k, v = (torch.randn((B, S, 32, 64), generator=g, device=cuda_device)
                       .to(dtype) for S in (Sq, Sk, Sk))
            off = torch.randint(0, Sk - Sq + 1, (B,), generator=g, device=cuda_device)
            kw = dict(causal=True, q_offset=off, kv_len=off + Sq)
            out = t_attn._flash(q, k, v, **kw)
            ref = t_attn.dense_attention(q.float(), k.float(), v.float(), **kw)
            torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
        x = torch.randn((256, 2048), generator=g, device=cuda_device).to(dtype)
        s = torch.randn((2048,), generator=g, device=cuda_device)
        torch.testing.assert_close(rms_ops.rmsnorm(x, s).float(),
                                   rms_ops.rmsnorm_reference(x, s).float(),
                                   atol=tol, rtol=tol)
    assert flash_ops.flash_attention_fwd.launches > n_flash
    assert rms_ops.rmsnorm.launches > n_rms


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.randn((1, 4, 2, 64), device=cuda_device)
    with pytest.raises(TypeError):
        flash_ops.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):                     # head_dim not 32/64/128
        flash_ops.flash_attention_fwd(q[..., :48].contiguous(), q[..., :48].contiguous(),
                                      q[..., :48].contiguous())
    with pytest.raises(ValueError):                     # not contiguous
        t = q.transpose(1, 2)
        flash_ops.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError):                     # positions of the wrong dtype
        pos = torch.arange(4, device=cuda_device)
        flash_ops.flash_attention_fwd(q, q, q, q_pos=pos, k_pos=pos)
    with pytest.raises(ValueError):                     # mixed devices
        flash_ops.flash_attention_fwd(q, q.cpu(), q)
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(torch.randn((2, 64), device=cuda_device), torch.ones(32, device=cuda_device))


def test_cuda_serving_kernel_path_matches_ref_path(cuda_device):
    """Reduced llama3.2-1b served in fp32 on the card: the kernel path emits
    the plain path's greedy tokens, and both kernels ran."""
    config = serving.ServeConfig(
        arch="llama3.2-1b", reduced=True, device="cuda",
        cache=serving.CacheConfig(max_context=48, page_size=8),
        scheduler=serving.SchedulerConfig(num_slots=2, prefill_chunk=8))
    cfg = config.model_config()
    params = build_model(cfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(5))
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 19), dtype=np.int32)
    tokens = {}
    counts = (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches)
    for impl in ("kernel", "ref"):
        s = serving.build(config, model=build_model(cfg, impl=impl, device=cuda_device),
                          params=params, dtype=torch.float32)
        streams = [s.submit(serving.Request(prompt=p, max_new=9)) for p in prompts]
        s.run_until_drained()
        tokens[impl] = [st.request.tokens for st in streams]
        if impl == "kernel":
            after = (flash_ops.flash_attention_fwd.launches, rms_ops.rmsnorm.launches)
            assert all(a > c for a, c in zip(after, counts))
    assert tokens["kernel"] == tokens["ref"]
