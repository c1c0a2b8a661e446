from repro_torch.data.synthetic import (clustered_dataset, paper_dataset,
                                        query_split)

__all__ = ["clustered_dataset", "paper_dataset", "query_split"]
