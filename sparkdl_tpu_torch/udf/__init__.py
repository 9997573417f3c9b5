"""Model-serving SQL UDFs: port of ``sparkdl_tpu.udf``.

``registerKerasImageUDF`` registers a Keras model as a named SQL UDF over an
image-struct (or file-path) column; ``makeGraphUDF`` registers any
:class:`~sparkdl_tpu_torch.graph.TorchFunction` over tensor columns.
"""

from sparkdl_tpu_torch.udf.keras_image_model import registerKerasImageUDF  # noqa: F401
from sparkdl_tpu_torch.graph.tensorframes_udf import makeGraphUDF  # noqa: F401
