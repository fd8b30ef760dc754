from repro_torch.roofline.analysis import H100, V5E, HardwareSpec, roofline_report
from repro_torch.roofline.op_count import StepCount, count_step

__all__ = ["H100", "V5E", "HardwareSpec", "StepCount", "count_step", "roofline_report"]
