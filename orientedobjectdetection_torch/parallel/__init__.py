from .train_state import normalize_images

__all__ = ['normalize_images']
