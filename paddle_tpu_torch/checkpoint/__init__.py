"""paddle_tpu_torch.checkpoint: async sharded training checkpoints, the port
of paddle_tpu.checkpoint (the same on-disk format: a checkpoint written by
either package restores in the other), and ``training_state`` /
``load_training_state`` to carry a model and its optimizer through one."""
from .manager import (  # noqa: F401
    FORMAT,
    MANIFEST,
    CheckpointCorrupt,
    CheckpointError,
    CheckpointManager,
    NoCheckpoint,
    RestoredCheckpoint,
    load_training_state,
    read_manifest,
    reshard_rows,
    step_dirs,
    training_state,
    verify_checkpoint,
)
