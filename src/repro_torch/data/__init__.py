from repro_torch.data.pipeline import (DATASET_PRESETS, TokenPipeline,
                                       VectorDataset, make_token_pipeline,
                                       preset_dataset, synthetic_vectors)

__all__ = ["DATASET_PRESETS", "TokenPipeline", "VectorDataset",
           "make_token_pipeline", "preset_dataset", "synthetic_vectors"]
