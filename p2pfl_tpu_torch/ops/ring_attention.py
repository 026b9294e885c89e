"""Softmax attention over one device's blocks: the device-local half of
``p2pfl_tpu/ops/ring_attention.py``.

- ``reference_attention``: plain softmax attention in the ``[b, s, h,
  d]`` layout, the parity oracle of the attention tests and the block
  the JAX package's Ulysses scheme runs on its head shards;
- ``_block_attn``: one online-softmax (flash-attention) accumulation
  step over a block of keys and values, the body of the JAX package's
  ring loop.

The sequence-parallel schemes themselves (``ring_self_attention``,
``ulysses_attention``) rotate K/V blocks with ``ppermute`` or swap axes
with ``all_to_all`` over a mesh axis: they need the sequence spread
over several devices, which is ROADMAP item A24 (the node and sequence
axes over several GPUs through ``torch.distributed``). The ViT's own
attention (``models/vit.py``) is flax's ``dot_product_attention``, not
these functions, as in the JAX package when ``seq_axis`` is unset.
"""

from __future__ import annotations

import torch


def reference_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Softmax attention over ``[b, s, h, d]`` q, k, v: the logits in
    q's dtype, widened to f32 and divided by ``sqrt(d)``, the softmax in
    f32, the weights cast to v's dtype for the product with v."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / (d ** 0.5)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                scale: float):
    """One blockwise-softmax accumulation step.

    q ``[b, sq, h, d]``; k, v ``[b, sk, h, d]``; m, l ``[b, h, sq]`` the
    running row max and row sum (f32); o ``[b, h, sq, d]`` the f32
    accumulator. Returns ``(m', l', o')``; the attention over every
    block seen is ``o' / l'``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p.to(v.dtype), v).float()
    return m_new, l_new, o_new
