from repro_torch.checkpoint.io import (AsyncCheckpointer, check_loadable,
                                       is_committed, load_checkpoint,
                                       load_loader_state, resolve_checkpoint,
                                       save_checkpoint, step_dir)

__all__ = ["save_checkpoint", "load_checkpoint", "is_committed",
           "check_loadable", "load_loader_state", "resolve_checkpoint",
           "step_dir", "AsyncCheckpointer"]
