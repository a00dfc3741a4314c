"""Checkpoints: one ``.npy`` per leaf, committed through a manifest."""

from .store import CheckpointStore, restore_tree, save_tree

__all__ = ["CheckpointStore", "restore_tree", "save_tree"]
