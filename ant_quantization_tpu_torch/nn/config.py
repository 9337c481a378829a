"""Global quantization configuration, the typed form of the reference's
``quant_args``. Counterpart of the reference's ``nn/config.py``;
``compute_dtype`` is a torch dtype."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..calibrate.spec import SiteConfig

__all__ = ["QuantConfig", "FP32"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization settings carried by every quantized layer; mode, bits
    and the search bounds mirror the reference CLIs."""
    mode: str = "ant-int-pot-flint"
    wbit: int = 4
    abit: int = 4
    family: str = "ant"              # "ant" | "olive"
    w_low: int = 75
    w_up: int = 150
    a_low: int = 75
    a_up: int = 150
    no_outlier: bool = False         # OliVe: disable OVP
    percent: float = 1.0             # GOBO outlier-mode percentile [0,1]
    enabled: bool = True             # master switch
    quantize_input: bool = True
    compute_dtype: Any = torch.float32  # matmul dtype after fake-quant

    @property
    def scan_step(self) -> int:
        # ANT scans every 1%, OliVe every 2%
        return 2 if self.family == "olive" else 1

    def weight_site(self, channel_axis: int = -1,
                    pair_axis: int = 0) -> SiteConfig:
        return SiteConfig(
            bit=self.wbit, is_input=False, is_signed=True, mode=self.mode,
            family=self.family, w_low=self.w_low, w_up=self.w_up,
            a_low=self.a_low, a_up=self.a_up, scan_step=self.scan_step,
            no_outlier=self.no_outlier, channel_axis=channel_axis,
            pair_axis=pair_axis, percent=self.percent,
            enabled=self.enabled)

    def input_site(self, pair_axis: int = -1) -> SiteConfig:
        return SiteConfig(
            bit=self.abit, is_input=True, is_signed=False, mode=self.mode,
            family=self.family, w_low=self.w_low, w_up=self.w_up,
            a_low=self.a_low, a_up=self.a_up, scan_step=self.scan_step,
            no_outlier=self.no_outlier, pair_axis=pair_axis,
            percent=self.percent,
            enabled=self.enabled and self.quantize_input)


FP32 = QuantConfig(enabled=False)  # the unquantized baseline
