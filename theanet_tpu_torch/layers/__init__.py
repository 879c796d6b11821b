"""Layer registry (port of ``theanet_tpu/layers/__init__.py``). The net
builder dispatches layer-spec names through this module with getattr.

The port has the layers of the flagship, the deep and the flat-MLP fused
families: Input, Elastic, Color, Conv, Pool, Hidden, DropOut, and the
Softmax and CenteredOut heads. MeanLayer, the ExpLoss and Hinge heads and
the aux layers are queued in ROADMAP.md.
"""

from .base import Layer, DEFAULT_REG
from .input import InputLayer, ElasticLayer, ColorLayer
from .conv import ConvLayer, PoolLayer
from .dense import HiddenLayer, DropOutLayer
from .out import SoftmaxLayer, CenteredOutLayer, OutputMixin

__all__ = [
    "Layer",
    "DEFAULT_REG",
    "InputLayer",
    "ElasticLayer",
    "ColorLayer",
    "ConvLayer",
    "PoolLayer",
    "HiddenLayer",
    "DropOutLayer",
    "SoftmaxLayer",
    "CenteredOutLayer",
    "OutputMixin",
]
