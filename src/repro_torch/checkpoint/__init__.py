from repro_torch.checkpoint.manager import CheckpointManager, install_preemption_hook

__all__ = ["CheckpointManager", "install_preemption_hook"]
