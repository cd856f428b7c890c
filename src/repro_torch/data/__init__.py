from repro_torch.data.pipeline import (PFSDataPipeline, TokenSource,
                                       make_host_batch)

__all__ = ["PFSDataPipeline", "TokenSource", "make_host_batch"]
