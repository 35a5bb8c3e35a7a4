from repro_torch.checkpoint.checkpoint import (
    checkpoint_leaf_paths,
    load_checkpoint,
    load_federation_state,
    save_checkpoint,
    save_federation_state,
)

__all__ = ["checkpoint_leaf_paths", "load_checkpoint",
           "load_federation_state", "save_checkpoint",
           "save_federation_state"]
