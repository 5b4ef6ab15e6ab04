from repro_torch.data.synthetic import SyntheticBatches

__all__ = ["SyntheticBatches"]
