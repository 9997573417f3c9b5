"""Image structs and readers (a trimmed copy of ``sparkdl_tpu.image``)."""

from sparkdl_tpu_torch.image.imageIO import (
    filesToDF,
    imageArrayToStruct,
    imageSchema,
    imageStructToArray,
    imageType,
    readImages,
    readImagesWithCustomFn,
)

__all__ = [
    "imageSchema",
    "imageType",
    "imageArrayToStruct",
    "imageStructToArray",
    "readImages",
    "readImagesWithCustomFn",
    "filesToDF",
]
