"""Model hosting for the inline runner: one engine per model role on
one device (with an optimizer for the roles that train), the algorithm
interfaces of the MFCs, and MFC execution."""

from typing import List, Optional

from realhf_tpu_torch.api import data as data_api
from realhf_tpu_torch.api import model as model_api
from realhf_tpu_torch.api.config import ModelInterfaceType, ModelName
from realhf_tpu_torch.api.dfg import MFCDef
from realhf_tpu_torch.base import logging, seeding
from realhf_tpu_torch.base.device import DeviceLike, resolve_device
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig

logger = logging.getLogger("model_host", "benchmark")


def build_model(role: str, spec, tokenizer, init_seed: int,
                device: DeviceLike = None,
                total_steps: Optional[int] = None) -> model_api.Model:
    """Instantiate one model role on ``device`` (None = the CUDA card)
    with random weights drawn from (experiment seed, role), and its
    optimizer when the spec has one (``total_steps`` sizes the learning
    rate schedule)."""
    if spec.path:
        raise NotImplementedError(
            f"Model role {role!r}: loading checkpoints ({spec.path}) is "
            "deferred to the checkpoint-IO slice of the port; use "
            "random_init_config.")
    if spec.parallel.world_size > 1:
        raise NotImplementedError(
            f"Model role {role!r}: layouts over more than one device "
            f"({spec.parallel}) are deferred to the parallelism slice of "
            "the port.")
    if spec.random_init_config is None:
        raise ValueError(
            f"Model role {role!r} has neither a checkpoint path nor a "
            "random_init_config.")
    cfg = TransformerConfig(**spec.random_init_config,
                            is_critic=spec.is_critic)
    cfg.gradient_checkpointing = spec.gradient_checkpointing
    cfg.compute_dtype = "bfloat16" if spec.bf16 else "float32"
    if spec.bf16:
        cfg.param_dtype = "bfloat16"
    dev = resolve_device(device)
    gen = seeding.generator(
        seeding.derive_seed_from(init_seed, "model_init", role), dev)
    params = T.init_params(cfg, gen, dev)
    engine = Engine(cfg, params, dev, optimizer=spec.optimizer,
                    total_train_steps=total_steps)
    return model_api.Model(ModelName(role, 0), engine, tokenizer)


class ModelHost:
    """The models of some roles plus MFC execution."""

    def __init__(self, spec, roles: List[str], nodes: List[MFCDef],
                 tokenizer, device: DeviceLike = None,
                 total_steps: Optional[int] = None):
        self.spec = spec
        self.nodes = {n.name: n for n in nodes}
        self.models = {
            role: build_model(role, spec.models[role], tokenizer,
                              init_seed=spec.seed, device=device,
                              total_steps=total_steps)
            for role in roles
        }
        self.interfaces = {n.name: model_api.make_interface(n.interface_impl)
                           for n in nodes}

    def execute(self, node_name: str, inp: data_api.SequenceSample):
        """Run one MFC on its role's model."""
        node = self.nodes[node_name]
        model = self.models[node.role]
        if node.input_key_remap:
            inp = inp.select(list(inp.keys))
            inp.remap_keys_(node.input_key_remap)
        itf = self.interfaces[node_name]
        if node.interface_type == ModelInterfaceType.GENERATE:
            out = itf.generate(model, inp, n_mbs=node.n_mbs)
        elif node.interface_type == ModelInterfaceType.INFERENCE:
            out = itf.inference(model, inp, n_mbs=node.n_mbs)
        elif node.interface_type == ModelInterfaceType.TRAIN_STEP:
            out = itf.train_step(model, inp, n_mbs=node.n_mbs)
        else:
            raise NotImplementedError(node.interface_type)
        if isinstance(out, data_api.SequenceSample) and node.output_key_remap:
            out.remap_keys_(node.output_key_remap)
        return out

    def execute_level(self, named_inputs):
        """Run one topological level's ``(node_name, inp)`` MFCs in
        order (one device: nothing to overlap yet)."""
        return [self.execute(n, i) for n, i in named_inputs]
