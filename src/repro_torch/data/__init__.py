from repro_torch.data.pipeline import (DATASET_PRESETS, VectorDataset,
                                       preset_dataset, synthetic_vectors)

__all__ = ["DATASET_PRESETS", "VectorDataset", "preset_dataset",
           "synthetic_vectors"]
