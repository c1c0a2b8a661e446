from repro_torch.distributed.pipeline import bubble_fraction, gpipe

__all__ = ["bubble_fraction", "gpipe"]
