"""Dataflow graph of model function calls (MFCs).

An algorithm (PPO, DPO, generation, ...) is a DAG whose nodes are MFCs
-- generate / inference / train_step on a named model -- and whose
edges are resolved from input/output data keys. The graph is kept as
plain adjacency lists.
"""

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

from realhf_tpu_torch.api.config import (
    ModelInterfaceAbstraction,
    ModelInterfaceType,
    ModelName,
)


@dataclasses.dataclass
class OffloadHook:
    """Post-hook: move the model's weights to host memory after the MFC
    completes."""


@dataclasses.dataclass
class ParamReallocHook:
    """Pre- or post-hook: reshard weights between a role's replicas.

    Exactly one of ``source``/``target`` is set; the other side is the
    hooked MFC's own model. ``target = eta * source + (1 - eta) *
    target`` (eta = 1 overwrites; eta < 1 makes an EMA reference). The
    model host reads ``eta`` from a pre-hook for the refresh of a
    replica before its MFC (``system/model_host.py``)."""
    source: Optional[ModelName] = None
    target: Optional[ModelName] = None
    eta: float = 1.0


RPCHook = Union[OffloadHook, ParamReallocHook]


@dataclasses.dataclass
class MFCDef:
    """One model function call node.

    :param name: unique node name.
    :param n_seqs: batch size in sequences.
    :param interface_type: generate / inference / train_step.
    :param interface_impl: registry config of the algorithm interface.
    :param model_name: which model executes this call (a str role is
        promoted to ``ModelName(role, 0)``).
    :param input_keys / output_keys: data keys for dependency edges.
    :param input_key_remap / output_key_remap: rename keys between the
        graph-level naming and the interface's naming.
    :param n_mbs: number of microbatches when executing.
    """

    name: str
    n_seqs: int
    interface_type: ModelInterfaceType
    interface_impl: ModelInterfaceAbstraction
    model_name: Union[str, ModelName]

    input_keys: Tuple = dataclasses.field(default_factory=tuple)
    input_key_remap: Dict[str, str] = dataclasses.field(default_factory=dict)
    output_keys: Tuple = dataclasses.field(default_factory=tuple)
    output_key_remap: Dict[str, str] = dataclasses.field(default_factory=dict)

    n_mbs: Optional[int] = None
    log_return_value: bool = False

    # Filled by build_graph; not user-set.
    _G: Optional["Graph"] = None
    _pre_hooks: List[RPCHook] = dataclasses.field(default_factory=list)
    _post_hooks: List[RPCHook] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if isinstance(self.model_name, str):
            self.model_name = ModelName(role=self.model_name, replica_id=0)

    def __repr__(self):
        return f"MFCDef[{self.name}]"

    def __hash__(self):
        return hash(self.name)

    @property
    def role(self) -> str:
        return self.model_name.role

    def add_pre_hook(self, h: RPCHook):
        if isinstance(h, OffloadHook):
            raise ValueError("Offload can only be a post hook.")
        if isinstance(h, ParamReallocHook):
            assert (h.source is None) != (h.target is None)
        self._pre_hooks.append(h)

    def add_post_hook(self, h: RPCHook):
        if isinstance(h, ParamReallocHook):
            assert (h.source is None) != (h.target is None)
        self._post_hooks.append(h)

    @property
    def is_src(self) -> bool:
        return not self._G.preds[self.name]

    @property
    def is_dst(self) -> bool:
        return not self._G.succs[self.name]

    def all_successors(self) -> List["MFCDef"]:
        """Every node reachable from this one."""
        seen, stack = [], list(self._G.succs[self.name])
        while stack:
            n = stack.pop()
            if n not in seen:
                seen.append(n)
                stack.extend(self._G.succs[n])
        return [self._G.nodes[n] for n in seen]

    @property
    def is_dst_of_model_role(self) -> bool:
        """True iff no (transitive) successor runs on the same model
        role: this MFC is the last user of these weights in a step, so
        an offload hook may follow it."""
        return not any(r.role == self.role for r in self.all_successors())


@dataclasses.dataclass
class Graph:
    """MFC names with their node objects and predecessor / successor
    lists, plus which node produces each data key."""
    nodes: Dict[str, MFCDef]
    preds: Dict[str, List[str]]
    succs: Dict[str, List[str]]
    data_producers: Dict[str, MFCDef]

    def topological_generations(self) -> List[List[str]]:
        """Kahn's algorithm by levels; raises on a cycle."""
        indeg = {n: len(p) for n, p in self.preds.items()}
        level = [n for n in self.nodes if indeg[n] == 0]
        out, done = [], 0
        while level:
            out.append(level)
            done += len(level)
            nxt = []
            for n in level:
                for c in self.succs[n]:
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        nxt.append(c)
            level = nxt
        if done != len(self.nodes):
            raise ValueError("The MFC graph contains a cycle.")
        return out


def build_graph(nodes: List[MFCDef]) -> Graph:
    """Resolve edges from data keys: an edge A->B exists iff some output
    key of A is an input key of B. Keys produced by no node come from
    the dataset."""
    if len({n.name for n in nodes}) != len(nodes):
        raise ValueError(f"Duplicate MFC names: {[n.name for n in nodes]}")
    data_producers: Dict[str, MFCDef] = {}
    for node in nodes:
        for k in node.output_keys:
            if k in data_producers:
                raise ValueError(
                    f"Data key `{k}` produced by both "
                    f"{data_producers[k].name} and {node.name}.")
            data_producers[k] = node
    G = Graph(nodes={n.name: n for n in nodes},
              preds={n.name: [] for n in nodes},
              succs={n.name: [] for n in nodes},
              data_producers=data_producers)
    for node in nodes:
        for k in node.input_keys:
            if k in data_producers:
                src = data_producers[k].name
                if src not in G.preds[node.name]:
                    G.preds[node.name].append(src)
                    G.succs[src].append(node.name)
    for node in nodes:
        node._G = G
    G.topological_generations()  # raises on a cycle
    return G


class DFG:
    """The nodes plus their resolved graph."""

    def __init__(self, nodes: List[MFCDef]):
        self.nodes = list(nodes)
        self.G = build_graph(self.nodes)

    @property
    def sources(self) -> List[MFCDef]:
        return [n for n in self.nodes if n.is_src]

    def topological_levels(self) -> List[List[MFCDef]]:
        """Antichain levels: every node's producers live in earlier
        levels, so the nodes within a level are mutually independent."""
        return [[self.G.nodes[x] for x in gen]
                for gen in self.G.topological_generations()]
