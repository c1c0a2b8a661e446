from repro_torch.data.synthetic import (LMDataIterator, clustered_dataset,
                                        lm_batch, paper_dataset, query_split)

__all__ = ["LMDataIterator", "clustered_dataset", "lm_batch",
           "paper_dataset", "query_split"]
