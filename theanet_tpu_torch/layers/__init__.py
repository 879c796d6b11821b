"""Layer registry (port of ``theanet_tpu/layers/__init__.py``). The net
builder dispatches layer-spec names through this module with getattr.

Every layer of the JAX package: Input, Elastic, Color, Conv, Pool, Mean,
Hidden, DropOut, the aux layers (AuxConcat, and the SoftAux head), and the
Softmax, ExpLoss, Hinge and CenteredOut heads.
"""

from .base import Layer, DEFAULT_REG
from .input import InputLayer, ElasticLayer, ColorLayer
from .conv import ConvLayer, PoolLayer, MeanLayer
from .dense import HiddenLayer, DropOutLayer
from .out import (SoftmaxLayer, ExpLossLayer, HingeLayer, CenteredOutLayer,
                  OutputMixin)
from .aux import LocationInfo, AuxConcatLayer, SoftAuxLayer

__all__ = [
    "Layer",
    "DEFAULT_REG",
    "InputLayer",
    "ElasticLayer",
    "ColorLayer",
    "ConvLayer",
    "PoolLayer",
    "MeanLayer",
    "HiddenLayer",
    "DropOutLayer",
    "SoftmaxLayer",
    "ExpLossLayer",
    "HingeLayer",
    "CenteredOutLayer",
    "LocationInfo",
    "AuxConcatLayer",
    "SoftAuxLayer",
    "OutputMixin",
]
