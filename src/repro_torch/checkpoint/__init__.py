from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager,
    checkpoint_step,
    leaf_shapes,
    restore_tree,
    save_tree,
)
