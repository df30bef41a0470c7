"""Pipeline layers: the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``
(``LayerDesc`` :20, ``SharedLayerDesc`` :33, ``PipelineLayer`` :46).

The layer list is cut uniformly into S x V contiguous chunks; chunk c
lives on stage c % S (the Megatron VPP layout, as in the JAX package).
Stages are real: with a hybrid topology of pp > 1 (``fleet.init``), stage
s's parameters live on the hybrid mesh's device at pp = s with the other
coordinates at 0, and its layers run there. A stage's dp and mp ranks see
its activations replicated (``pp_layers.py:101-135``); the single
controller computes that replicated part once, on that position, as the
mesh engine does. An activation that crosses from one stage to the next
goes by a counted transfer (``stage_transfer``: one ``send`` and one
``recv`` in ``collective_calls_total`` / ``collective_bytes_total``, and
the same for its gradient on the way back), the counterpart of the JAX
package's ``p2p_transfer`` (``pp_layers.py:156-158``).

A ``SharedLayerDesc`` layer (a tied embedding and head) is built once and
its parameters are ONE set of tensors, registered once (under the index
of its first use, as the JAX model names it), on the stage of its first
use. A later stage that uses it gets its shared weight (the desc's
``shared_weight_attr``, a dotted name) by the same counted transfer, so
the gradients of both uses sum into the one parameter.
"""

from __future__ import annotations

import torch

from ....nn.layers import Layer
from ... import parallel_base as pb
from ...fleet.base.topology import get_hcg


class LayerDesc:
    def __init__(self, layer_class, *args, **kwargs):
        self.layer_class = layer_class
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_class(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_class.__name__})"


class SharedLayerDesc(LayerDesc):
    """Parameters shared across stages (a tied embedding, ``pp_layers.py``
    :76 of the reference): the first desc with a key builds the layer,
    the later ones reuse it, calling ``forward_func(layer, x)`` when
    given."""

    def __init__(self, key, layer_class, *args, forward_func=None,
                 shared_weight_attr="weight", **kwargs):
        super().__init__(layer_class, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _StageTransfer(torch.autograd.Function):
    """x to `device`, counted as one send and one recv; its gradient goes
    back the same way, counted likewise."""

    @staticmethod
    def forward(ctx, x, device):
        ctx.home = x.device
        pb._count_collective("send", x)
        pb._count_collective("recv", x)
        return x.to(device)

    @staticmethod
    def backward(ctx, g):
        pb._count_collective("send", g)
        pb._count_collective("recv", g)
        return g.to(ctx.home), None


def stage_transfer(x, device):
    """Move activation `x` to the next stage's `device` (counted; the
    gradient flows back through it)."""
    return _StageTransfer.apply(x, device)


class _Use(torch.nn.Module):
    """One use of a shared layer: ``forward_func(layer, x)`` or
    ``layer(x)``, for ``torch.func.functional_call`` over the layer's
    transferred parameters."""

    def __init__(self, layer, ffn):
        super().__init__()
        self.layer = layer
        self.ffn = ffn

    def forward(self, x):
        return self.ffn(self.layer, x) if self.ffn is not None \
            else self.layer(x)


class PipelineLayer(Layer):
    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=None, **kwargs):
        super().__init__()
        self._desc_list = list(layers)
        hcg = get_hcg()
        self._num_stages = num_stages or (
            hcg.get_pipe_parallel_world_size() if hcg else 1)
        self._num_virtual = int(num_virtual_pipeline_stages or 1)
        # a plain attribute, a loss Module included (not a sublayer)
        self.__dict__["_loss_fn"] = loss_fn
        self._recompute_interval = recompute_interval
        self._shared = {}

        built = []
        self._shared_attr = {}          # id(shared layer) -> its weight
        for desc in self._desc_list:
            if isinstance(desc, SharedLayerDesc):
                layer = self._shared.get(desc.layer_name)
                if layer is None:
                    layer = self._shared[desc.layer_name] = \
                        desc.build_layer()
                self._shared_attr[id(layer)] = desc.shared_weight_attr
                built.append((layer, desc.forward_func))
            elif isinstance(desc, LayerDesc):
                built.append((desc.build_layer(), None))
            elif callable(desc):
                built.append((desc, None))
            else:
                raise TypeError(f"bad layer desc {desc}")

        self.run_function = []
        registered = set()
        for i, (layer, ffn) in enumerate(built):
            if isinstance(layer, torch.nn.Module) and \
                    id(layer) not in registered:
                registered.add(id(layer))
                self.add_sublayer(str(i), layer)
            self.run_function.append((layer, ffn))

        # uniform split of the layer list into S*V contiguous chunks;
        # chunk c lives on stage c % S
        n = len(self.run_function)
        n_chunks = self._num_stages * self._num_virtual
        per = [n // n_chunks] * n_chunks
        for i in range(n % n_chunks):
            per[i] += 1
        bounds = [0]
        for k in per:
            bounds.append(bounds[-1] + k)
        self._chunk_bounds = [(bounds[i], bounds[i + 1])
                              for i in range(n_chunks)]
        self._stage_bounds = self._chunk_bounds[:self._num_stages] \
            if self._num_virtual == 1 else None
        self._place_stages()

    def _place_stages(self):
        """Tag each layer's parameters with their stage (``_pp_stage``, the
        stage of the layer's first use) and, with a hybrid mesh whose pp
        axis has this many stages, move them to the stage's device."""
        hcg = get_hcg()
        mesh = hcg.mesh if hcg is not None else None
        self._stage_devices = None
        if mesh is not None and mesh.shape["pp"] == self._num_stages and \
                self._num_stages > 1:
            self._stage_devices = mesh.axis_devices("pp")
        self._home_stage = {}          # id(layer) -> its stage
        for c, (lo, hi) in enumerate(self._chunk_bounds):
            s = c % self._num_stages
            for idx in range(lo, hi):
                layer, _ = self.run_function[idx]
                if not isinstance(layer, torch.nn.Module) or \
                        id(layer) in self._home_stage:
                    continue
                self._home_stage[id(layer)] = s
                for p in layer.parameters():
                    p._pp_stage = s
                if self._stage_devices is not None:
                    dev = self._stage_devices[s]
                    with torch.no_grad():
                        for t in list(layer.parameters()) + \
                                list(layer.buffers()):
                            if t.device != dev:
                                t.data = t.data.to(dev)

    def get_stage_from_index(self, idx):
        for c, (lo, hi) in enumerate(self._chunk_bounds):
            if lo <= idx < hi:
                return c % self._num_stages
        return self._num_stages - 1

    def chunk_slice(self, chunk):
        lo, hi = self._chunk_bounds[chunk]
        return self.run_function[lo:hi]

    def stage_slice(self, stage):
        """V=1 only: the stage's layer slice."""
        return self.chunk_slice(stage)

    def stage_device(self, stage):
        """The device stage `stage` runs on (None without stages)."""
        if self._stage_devices is None:
            return None
        return self._stage_devices[stage]

    def forward_chunk(self, x, chunk):
        """Run one virtual chunk on its stage: the input moves there first
        (counted when it comes from another stage)."""
        stage = chunk % self._num_stages
        dev = self.stage_device(stage)
        if dev is not None:
            prev = (chunk - 1) % self._num_stages
            if chunk > 0 and prev != stage:
                x = stage_transfer(x, dev)
            elif x.device != dev:
                x = x.to(dev)           # the batch's placement on stage 0
        for layer, ffn in self.chunk_slice(chunk):
            home = self._home_stage.get(id(layer), stage)
            if dev is not None and home != stage:
                x = self._remote(layer, ffn, x, dev,
                                 self._shared_attr[id(layer)])
            elif ffn is not None:
                x = ffn(layer, x)
            else:
                x = layer(x)
        return x

    @staticmethod
    def _remote(layer, ffn, x, dev, attr):
        """A shared layer used on a stage other than its own: its shared
        weight `attr` comes over by the counted transfer."""
        w = layer.get_parameter(attr)
        return torch.func.functional_call(
            _Use(layer, ffn), {f"layer.{attr}": stage_transfer(w, dev)},
            (x,), strict=False)

    def forward_stage(self, x, stage):
        """Run one stage (V=1 path; chunk == stage)."""
        return self.forward_chunk(x, stage)

    def forward(self, x):
        for c in range(len(self._chunk_bounds)):
            x = self.forward_chunk(x, c)
        return x

    @property
    def parameters_by_stage(self):
        out = [[] for _ in range(self._num_stages)]
        for c in range(len(self._chunk_bounds)):
            for layer, _ in self.chunk_slice(c):
                if isinstance(layer, torch.nn.Module):
                    out[c % self._num_stages].extend(layer.parameters())
        return out
