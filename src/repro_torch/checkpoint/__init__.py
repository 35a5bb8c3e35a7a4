from repro_torch.checkpoint.checkpoint import (
    checkpoint_leaf_paths,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["checkpoint_leaf_paths", "load_checkpoint", "save_checkpoint"]
