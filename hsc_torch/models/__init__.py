from .coder import (
    ConvolutionalMatchingPursuit,
    ConvolutionalSparseCoder,
    HierarchicalConvolutionalSparseCoder,
)

__all__ = [
    "ConvolutionalMatchingPursuit",
    "ConvolutionalSparseCoder",
    "HierarchicalConvolutionalSparseCoder",
]
