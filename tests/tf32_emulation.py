"""The hand-written kernels' 3xTF32 arithmetic, emulated on the CPU: shared
by the flash-attention tests (``test_torch_attention.py``, the forward;
``test_torch_flash_grad.py``, the backward)."""
import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (the low 13 bits cleared).  Adding half an
    ulp to the sign-magnitude bits rounds the magnitude for either sign."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def tf32_dot(eq: str, a: torch.Tensor, b: torch.Tensor,
             split: bool) -> torch.Tensor:
    """An fp32-accumulated product of TF32 operands.  ``split``: the 3xTF32
    form, lo.hi + hi.lo before hi.hi, with hi = tf32(x) and
    lo = tf32(x - hi); otherwise one TF32 product hi.hi.  Products of two
    TF32 values are exact in fp32, so only the sums round, as in the
    tensor cores' fp32 accumulation."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    if not split:
        return torch.einsum(eq, ah, bh)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))
