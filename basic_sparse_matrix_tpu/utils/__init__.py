from .errors import (
    ConfigError,
    IncorrectDimensions,
    MatErr,
    MatrixFinalised,
    MatrixNotFinalised,
    NonSquareMatrix,
    OutOfBounds,
    PaddingSizeSmallerThanOriginal,
    check,
)
from .shapes import DimLike, MatDim

__all__ = [
    "ConfigError",
    "MatDim",
    "DimLike",
    "MatErr",
    "MatrixFinalised",
    "MatrixNotFinalised",
    "NonSquareMatrix",
    "IncorrectDimensions",
    "PaddingSizeSmallerThanOriginal",
    "OutOfBounds",
    "check",
]
