"""QuantConfig (counterpart of ``paddle_tpu/quantization/config.py``).

Maps layers to (activation quanter, weight quanter) pairs. Precedence:
a config pinned to the layer instance, then its full name, then its type,
then the global config.
"""

from __future__ import annotations

__all__ = ["QuantConfig", "SingleLayerConfig"]


class SingleLayerConfig:
    def __init__(self, activation, weight):
        self._activation = activation
        self._weight = weight

    @property
    def activation(self):
        return self._activation

    @property
    def weight(self):
        return self._weight

    def __str__(self):
        return f"activation: {self._activation}\nweight: {self._weight}"


class QuantConfig:
    def __init__(self, activation=None, weight=None):
        if activation is None and weight is None:
            self._global_config = None
        else:
            self._global_config = SingleLayerConfig(activation, weight)
        self._layer2config: dict[int, SingleLayerConfig] = {}
        self._name2config: dict[str, SingleLayerConfig] = {}
        self._type2config: dict[type, SingleLayerConfig] = {}

    def add_layer_config(self, layer, activation=None, weight=None):
        """Pin a config to layer instances (the highest precedence)."""
        layers = layer if isinstance(layer, (list, tuple)) else [layer]
        for lay in layers:
            self._layer2config[id(lay)] = SingleLayerConfig(activation, weight)

    def add_name_config(self, layer_name, activation=None, weight=None):
        names = layer_name if isinstance(layer_name, (list, tuple)) \
            else [layer_name]
        for n in names:
            self._name2config[n] = SingleLayerConfig(activation, weight)

    def add_type_config(self, layer_type, activation=None, weight=None):
        types = layer_type if isinstance(layer_type, (list, tuple)) \
            else [layer_type]
        for t in types:
            self._type2config[t] = SingleLayerConfig(activation, weight)

    def config_for(self, layer, full_name: str = ""):
        if id(layer) in self._layer2config:
            return self._layer2config[id(layer)]
        if full_name and full_name in self._name2config:
            return self._name2config[full_name]
        for t, cfg in self._type2config.items():
            if isinstance(layer, t):
                return cfg
        return self._global_config

    def __str__(self):
        out = []
        if self._global_config is not None:
            out.append(f"Global config:\n{self._global_config}")
        if self._type2config:
            out.append(f"Layer type config: {list(self._type2config)}")
        if self._name2config:
            out.append(f"Layer name config: {list(self._name2config)}")
        return "\n".join(out)
