"""The port's CUDA kernels on the card, held against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The card's
machine has no JAX, so run them there without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -o markers=cuda -m cuda \
        tests/test_torch_cuda.py -q
"""

import pytest
import torch

from nxdi_tpu_torch.ops.kernels import flash_attention as fa
from nxdi_tpu_torch.ops.kernels import kv_commit as kc

pytestmark = pytest.mark.cuda

TOL = 1e-5  # float32


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda")


def test_prefill_takes_positions_from_the_host(gen):
    """Position tensors on the CPU with operands on the card: the wrapper
    moves the starts to the card, launches once, and matches the plain
    version."""
    B, H, KV, S, D = 2, 4, 2, 40, 16
    q, k, v = _randn(gen, B, H, S, D), _randn(gen, B, KV, S, D), _randn(gen, B, KV, S, D)
    pos = torch.arange(S, dtype=torch.int32)[None] + torch.tensor([[0], [9]], dtype=torch.int32)
    before = fa.flash_attention_prefill.launches
    got = fa.flash_attention_prefill(q, k, v, pos, pos)
    assert fa.flash_attention_prefill.launches == before + 1
    want = fa.flash_attention_prefill_plain(q, k, v, pos.cuda(), pos.cuda())
    assert (got - want).abs().max().item() <= TOL


def test_fused_decode_takes_positions_from_the_host(gen):
    B, H, KV, S, D = 2, 8, 2, 64, 16
    q, kn, vn = _randn(gen, B, H, 1, D), _randn(gen, B, KV, 1, D), _randn(gen, B, KV, 1, D)
    kc_, vc_ = _randn(gen, B, KV, S, D), _randn(gen, B, KV, S, D)
    q_pos = torch.tensor([[17], [0]], dtype=torch.int32)
    kv_pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    before = fa.flash_attention_decode_fused.launches
    got = fa.flash_attention_decode_fused(q, kc_, vc_, kn, vn, q_pos, kv_pos, kv_len=48)
    assert fa.flash_attention_decode_fused.launches == before + 1
    want = fa.flash_attention_decode_fused_plain(q, kc_, vc_, kn, vn, q_pos.cuda(), kv_len=48)
    assert (got - want).abs().max().item() <= TOL


def test_commit_takes_slots_from_the_host(gen):
    L, B, KV, S, D = 3, 4, 2, 32, 16
    k_cache, v_cache = _randn(gen, L, B, KV, S, D), _randn(gen, L, B, KV, S, D)
    k_rows, v_rows = _randn(gen, L, B, KV, 1, D), _randn(gen, L, B, KV, 1, D)
    slots = torch.tensor([[3], [-1], [31], [0]], dtype=torch.int32)
    k_ref, v_ref = k_cache.clone(), v_cache.clone()
    kc.kv_commit_rows_plain(k_ref, v_ref, k_rows, v_rows, slots.cuda())
    before = kc.kv_commit_rows.launches
    kc.kv_commit_rows(k_cache, v_cache, k_rows, v_rows, slots)
    assert kc.kv_commit_rows.launches == before + 1
    assert torch.equal(k_cache, k_ref) and torch.equal(v_cache, v_ref)


def test_window_decode_takes_positions_from_the_host(gen):
    B, H, KV, S, D = 2, 8, 2, 64, 16
    q, k, v = _randn(gen, B, H, 1, D), _randn(gen, B, KV, S, D), _randn(gen, B, KV, S, D)
    q_pos = torch.tensor([[17], [63]], dtype=torch.int32)
    kv_pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    before = fa.flash_attention_decode.launches
    got = fa.flash_attention_decode(q, k, v, q_pos, kv_pos)
    assert fa.flash_attention_decode.launches == before + 1
    want = fa.flash_attention_decode_plain(q, k, v, q_pos.cuda(), kv_pos.cuda())
    assert (got - want).abs().max().item() <= TOL


def _paged_case(gen, Sq):
    """A 12-block pool of 8 slots and host-side int32 tables with a hole
    and a right-padded row."""
    B, H, KV, D, bs = 2, 8, 2, 16, 8
    kc, vc = _randn(gen, 12 * bs, KV, D), _randn(gen, 12 * bs, KV, D)
    bt = torch.tensor([[3, 7, -1, 1, 0, 5], [11, 2, 9, -1, -1, -1]], dtype=torch.int32)
    start = torch.tensor([[30], [10]], dtype=torch.int32)
    q_pos = start + torch.arange(Sq, dtype=torch.int32)[None]
    return _randn(gen, B, H, Sq, D), kc, vc, bt, q_pos, bs


def test_paged_decode_takes_tables_from_the_host(gen):
    q, kc, vc, bt, q_pos, bs = _paged_case(gen, 1)
    before = fa.paged_attention_decode.launches
    got = fa.paged_attention_decode(q, kc, vc, bt, q_pos, block_size=bs, k_scale=0.5, v_scale=2.0)
    assert fa.paged_attention_decode.launches == before + 1
    want = fa.paged_attention_decode_plain(q, kc, vc, bt.cuda(), q_pos.cuda(), block_size=bs,
                                           k_scale=0.5, v_scale=2.0)
    assert (got - want).abs().max().item() <= TOL


def test_paged_prefill_takes_tables_from_the_host(gen):
    q, kc, vc, bt, q_pos, bs = _paged_case(gen, 12)
    before = fa.paged_attention_prefill.launches
    got = fa.paged_attention_prefill(q, kc, vc, bt, q_pos, block_size=bs, k_scale=1.5,
                                     v_scale=0.25)
    assert fa.paged_attention_prefill.launches == before + 1
    want = fa.paged_attention_prefill_plain(q, kc, vc, bt.cuda(), q_pos.cuda(), block_size=bs,
                                            k_scale=1.5, v_scale=0.25)
    assert (got - want).abs().max().item() <= TOL
