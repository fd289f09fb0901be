from .clip_vision import ClipVisionConfig, build_clip_vision

__all__ = ["ClipVisionConfig", "build_clip_vision"]
