from repro_torch.core.dap.base import DapClient, make_dap
from repro_torch.core.dap.abd import AbdDap
from repro_torch.core.dap.ec import EcDap

__all__ = ["DapClient", "make_dap", "AbdDap", "EcDap"]
