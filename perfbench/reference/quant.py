"""The control's precision: symmetric per-output-channel weight-only
integer quantization at ``bits`` (4: one step below the int8 the
configurations state for the decoder's matmuls)."""
import torch


def fake_quant(w: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """``w`` [in, out] rounded to ``2**(bits-1) - 1`` levels a side per
    output column, returned dequantized in float32."""
    top = 2 ** (bits - 1) - 1
    s = torch.clamp(w.float().abs().amax(dim=-2, keepdim=True) / top, min=1e-8)
    return torch.clamp(torch.round(w.float() / s), -top, top) * s
