"""A configuration's net as shapes and settings, read from its layer list
(the ``.prms`` structure: ``[[layer name, {arguments}], ...]``).

The benchmark's own reading of a configuration: the reference, the FLOP
and byte counts and the harness take the net's shapes from here, never
from the program. The grammar is what the benchmark's configuration uses:
``ElasticLayer (nearest) -> (ConvLayer -> PoolLayer)+ -> HiddenLayer ->
SoftmaxLayer``, valid stride-1 convolutions and leaky-relu activations.
Anything else raises, so a configuration the reference cannot follow is
refused before a run.
"""

from __future__ import annotations

from dataclasses import dataclass

# the reference's per-layer regularisation defaults (theanet's
# convpool.py:80-84, hidden.py:39-43)
DEFAULT_REG = {"L1": 0.0, "L2": 0.0, "momentum": 0.95, "rate": 1.0,
               "maxnorm": 0.0}
HIDDEN_ACTVN = "relu01"        # HiddenLayer's default activation


def leaky_slope(actvn):
    """The negative slope of a leaky-relu activation name: 'relu' 0,
    'linear' 1, 'reluNN' NN/100."""
    if actvn == "relu":
        return 0.0
    if actvn == "linear":
        return 1.0
    if actvn.startswith("relu") and len(actvn) == 6 and actvn[4:].isdigit():
        return int(actvn[4:]) / 100.0
    raise ValueError(f"activation {actvn!r} is outside the benchmark's "
                     "grammar (leaky relus)")


def reg_of(args):
    reg = dict(DEFAULT_REG)
    reg.update(args.get("reg") or {})
    return {k: float(v) for k, v in reg.items()}


@dataclass(frozen=True)
class Level:
    """One conv level: a valid stride-1 conv of ``filt`` taps from ``cin``
    to ``maps`` maps, its activation, then a ``pool`` x ``pool`` max pool
    (ceil windows unless ``ib``)."""
    cin: int
    maps: int
    filt: int
    actvn: str
    pool: int
    ib: bool
    side_in: int
    reg: dict

    @property
    def slope(self):
        return leaky_slope(self.actvn)

    @property
    def side_conv(self):
        return self.side_in - self.filt + 1

    @property
    def side_pool(self):
        c = self.side_conv
        return c // self.pool if self.ib else -(-c // self.pool)


@dataclass(frozen=True)
class Net:
    batch: int
    img: int
    in_ch: int
    elastic: dict         # the ElasticLayer's settings
    levels: tuple
    n_hid: int
    hid_actvn: str
    pdrop: float          # the hidden layer's training dropout rate
    hid_reg: dict
    n_out: int            # the Softmax head's scores
    head_reg: dict

    @property
    def hw(self):
        return self.img * self.img

    @property
    def n_flat(self):
        last = self.levels[-1]
        return last.maps * last.side_pool ** 2

    @property
    def hid_slope(self):
        return leaky_slope(self.hid_actvn)

    @property
    def warp_active(self):
        e = self.elastic
        return bool(e["translation"] or e["magnitude"] or e["angle"]
                    or e["zoom"] != 1)

    def state_shapes(self):
        """The training state's leaves in order: per level the weights
        (maps, F*F*cin) and bias (maps, 1); the hidden's (n_flat, n_hid),
        (1, n_hid); the head's (n_hid, n_out), (1, n_out)."""
        shapes = []
        for lv in self.levels:
            shapes += [(lv.maps, lv.filt * lv.filt * lv.cin), (lv.maps, 1)]
        shapes += [(self.n_flat, self.n_hid), (1, self.n_hid),
                   (self.n_hid, self.n_out), (1, self.n_out)]
        return shapes

    def leaf_names(self):
        names = []
        for k in range(len(self.levels)):
            names += [f"conv{k + 1}.w", f"conv{k + 1}.b"]
        return names + ["hidden.w", "hidden.b", "head.w", "head.b"]

    def leaf_regs(self):
        """(reg, max-norm kind) of each leaf: conv weights clip their rows,
        dense weights their columns, biases their values."""
        out = []
        for lv in self.levels:
            out += [(lv.reg, "rows"), (lv.reg, "bias")]
        return out + [(self.hid_reg, "cols"), (self.hid_reg, "bias"),
                      (self.head_reg, "cols"), (self.head_reg, "bias")]


def _elastic_settings(args):
    return dict(translation=float(args.get("translation", 0)),
                zoom=float(args.get("zoom", 1)),
                magnitude=float(args.get("magnitude", 0)),
                sigma=int(args.get("sigma", 1)),
                pflip=float(args.get("pflip", 0)),
                angle=float(args.get("angle", 0)),
                invert=bool(args.get("invert_image", False)),
                nearest=bool(args.get("nearest", False)))


def net_from_layers(layers, batch, img, in_ch):
    """The Net of a layer list at ``batch`` on ``img`` x ``img`` inputs of
    ``in_ch`` channels; raises for a list outside the grammar."""
    names = [name for name, _ in layers]
    if names[0] != "ElasticLayer":
        raise ValueError("the first layer must be an ElasticLayer")
    elastic = _elastic_settings(layers[0][1])
    levels, cin, side, i = [], in_ch, img, 1
    while i < len(names) and names[i] == "ConvLayer":
        a = layers[i][1]
        if a.get("stride", 1) != 1 or a.get("mode", "valid") != "valid":
            raise ValueError("the benchmark's grammar takes valid stride-1 "
                             "convolutions only")
        if i + 1 >= len(names) or names[i + 1] != "PoolLayer":
            raise ValueError("each ConvLayer is followed by a PoolLayer")
        p = layers[i + 1][1]
        lv = Level(cin=cin, maps=int(a["num_maps"]),
                   filt=int(a["filter_sz"]), actvn=a.get("actvn", "relu50"),
                   pool=int(p["pool_sz"]),
                   ib=bool(p.get("ignore_border", False)), side_in=side,
                   reg=reg_of(a))
        leaky_slope(lv.actvn)
        levels.append(lv)
        cin, side = lv.maps, lv.side_pool
        i += 2
    if not levels or names[i:] != ["HiddenLayer", "SoftmaxLayer"]:
        raise ValueError("expected (ConvLayer -> PoolLayer)+ -> HiddenLayer "
                         "-> SoftmaxLayer")
    h, ha = layers[i][1], layers[i + 1][1]
    if ha.get("loss", "nll") != "nll":
        raise ValueError("the benchmark's Softmax head takes loss 'nll'")
    net = Net(batch=int(batch), img=int(img), in_ch=int(in_ch),
              elastic=elastic, levels=tuple(levels), n_hid=int(h["n_out"]),
              hid_actvn=h.get("actvn", HIDDEN_ACTVN),
              pdrop=float(h.get("pdrop", 0)), hid_reg=reg_of(h),
              n_out=int(ha["n_out"]), head_reg=reg_of(ha))
    leaky_slope(net.hid_actvn)
    if net.warp_active and not elastic["nearest"]:
        raise ValueError("the benchmark's grammar takes the nearest-pixel "
                         "elastic warp only")
    return net
