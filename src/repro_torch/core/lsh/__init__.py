from repro_torch.core.lsh.families import (BitSampling, PStableL1, PStableL2,
                                           SimHash, bucket_fn_for,
                                           k_from_delta, make_family)
from repro_torch.core.lsh.tables import (LSHTables, bucket_counts,
                                         build_tables, gather_candidates,
                                         gather_registers)

__all__ = ["BitSampling", "PStableL1", "PStableL2", "SimHash",
           "bucket_fn_for", "k_from_delta", "make_family", "LSHTables",
           "bucket_counts", "build_tables", "gather_candidates",
           "gather_registers"]
