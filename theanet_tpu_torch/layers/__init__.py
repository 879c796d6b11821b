"""Layer registry (port of ``theanet_tpu/layers/__init__.py``). The net
builder dispatches layer-spec names through this module with getattr.

This slice ports the flagship's layer classes. ColorLayer, MeanLayer,
ExpLoss/Hinge/CenteredOut heads and the aux layers are queued in ROADMAP.md.
"""

from .base import Layer, DEFAULT_REG
from .input import InputLayer, ElasticLayer
from .conv import ConvLayer, PoolLayer
from .dense import HiddenLayer, DropOutLayer
from .out import SoftmaxLayer, OutputMixin

__all__ = [
    "Layer",
    "DEFAULT_REG",
    "InputLayer",
    "ElasticLayer",
    "ConvLayer",
    "PoolLayer",
    "HiddenLayer",
    "DropOutLayer",
    "SoftmaxLayer",
    "OutputMixin",
]
