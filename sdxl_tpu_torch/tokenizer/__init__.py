from .bpe import ClipTokenizer, OpenClipTokenizer

__all__ = ["ClipTokenizer", "OpenClipTokenizer"]
