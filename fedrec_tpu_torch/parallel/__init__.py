"""Wire-client policy shared by the port's network clients."""

from fedrec_tpu_torch.parallel.rpc import backoff_delay_s

__all__ = ["backoff_delay_s"]
