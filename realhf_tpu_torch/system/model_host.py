"""Model hosting for the inline runner: one engine per model role on
one device (with an optimizer for the roles that train), or, for a role
that no MFC trains or generates with, on the members of a
context-parallel layout; the algorithm interfaces of the MFCs, MFC
execution, and each role's checkpoint (weights and optimizer state)."""

import os
from typing import Dict, List, Optional, Sequence

from realhf_tpu_torch.api import data as data_api
from realhf_tpu_torch.api import model as model_api
from realhf_tpu_torch.api.config import ModelInterfaceType, ModelName
from realhf_tpu_torch.api.dfg import MFCDef, OffloadHook
from realhf_tpu_torch.base import constants, logging, seeding
from realhf_tpu_torch.base.device import DeviceLike, resolve_device
from realhf_tpu_torch.engine import opt_checkpoint
from realhf_tpu_torch.engine.engine import Engine
from realhf_tpu_torch.models import hf
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig

logger = logging.getLogger("model_host", "benchmark")


def build_model(role: str, spec, tokenizer, init_seed: int,
                device: DeviceLike = None,
                total_steps: Optional[int] = None,
                devices: Optional[Sequence[DeviceLike]] = None,
                inference_only: bool = False) -> model_api.Model:
    """Instantiate one model role on ``device`` (None = the CUDA card):
    its weights from the HF-layout checkpoint at ``spec.path`` (streamed
    one layer at a time onto the device, the host holding one layer plus
    the embeddings), else drawn from (experiment seed, role); and its
    optimizer when the spec has one (``total_steps`` sizes the learning
    rate schedule), with the state saved beside the checkpoint when
    ``spec.restore_optimizer_state``.

    A context-parallel layout (``spec.parallel``: c > 1, d = t = p = 1)
    builds for an ``inference_only`` role (no MFC trains or generates
    with it) over ``devices`` (default ``cuda:0 .. c-1``, or c times the
    CPU when ``device`` is the CPU); the weights are placed on the first
    member's device. Every other layout of more than one device
    raises."""
    par = spec.parallel
    if par.world_size > 1 and (par.context_parallel_size != par.world_size
                               or not inference_only):
        raise NotImplementedError(
            f"Model role {role!r}: layout {par} over more than one device "
            "is deferred to the parallelism slice of the port (ROADMAP.md, "
            "queue 5); this slice runs context parallelism alone, on roles "
            "that no MFC trains or generates with.")
    dev = resolve_device(devices[0] if devices else device)
    is_critic = spec.is_critic or spec.init_critic_from_actor
    if spec.path:
        cfg, params = hf.load_hf_checkpoint_streamed(
            spec.path, dev, spec.hf_family, is_critic=is_critic,
            param_dtype="bfloat16" if spec.bf16 else None)
    elif spec.random_init_config is None:
        raise ValueError(
            f"Model role {role!r} has neither a checkpoint path nor a "
            f"random_init_config; pass `{role}.path=<hf-checkpoint>` (CLI) "
            "or set random_init_config on its ModelSpec.")
    else:
        cfg = TransformerConfig(**spec.random_init_config,
                                is_critic=spec.is_critic)
        params = None
    cfg.gradient_checkpointing = spec.gradient_checkpointing
    cfg.compute_dtype = "bfloat16" if spec.bf16 else "float32"
    if spec.bf16:
        cfg.param_dtype = "bfloat16"
    T.check_supported(cfg)
    if params is None:
        gen = seeding.generator(
            seeding.derive_seed_from(init_seed, "model_init", role), dev)
        params = T.init_params(cfg, gen, dev)
    engine = Engine(cfg, params, device, optimizer=spec.optimizer,
                    total_train_steps=total_steps, parallel=par,
                    devices=devices)
    if (spec.path and spec.restore_optimizer_state
            and engine.optimizer is not None):
        # the resume path only: a new run from a checkpoint starts with
        # fresh moments even where the directory holds a saved state
        opt_checkpoint.restore_engine_opt_state(engine, spec.path)
    return model_api.Model(ModelName(role, 0), engine, tokenizer,
                           hf_family=spec.hf_family)


class ModelHost:
    """The models of some roles plus MFC execution.

    ``role_devices`` names the devices of a role with a layout of more
    than one device (the JAX package's ``devices_fn``); a role it does
    not name takes ``build_model``'s default."""

    def __init__(self, spec, roles: List[str], nodes: List[MFCDef],
                 tokenizer, device: DeviceLike = None,
                 total_steps: Optional[int] = None,
                 role_devices: Optional[Dict[str, Sequence[DeviceLike]]]
                 = None):
        self.spec = spec
        self.nodes = {n.name: n for n in nodes}
        busy = {n.role for n in nodes if n.interface_type in (
            ModelInterfaceType.TRAIN_STEP, ModelInterfaceType.GENERATE)}
        role_devices = role_devices or {}
        self.models = {
            role: build_model(role, spec.models[role], tokenizer,
                              init_seed=spec.seed, device=device,
                              total_steps=total_steps,
                              devices=role_devices.get(role),
                              inference_only=role not in busy)
            for role in roles
        }
        self.interfaces = {n.name: model_api.make_interface(n.interface_impl)
                           for n in nodes}
        if spec.auto_offload:
            self._resolve_offload_hooks(nodes)

    @staticmethod
    def _resolve_offload_hooks(nodes: List[MFCDef]):
        """Attach an ``OffloadHook`` to the LAST MFC of every role that
        no MFC trains: the role's weights wait on the host between
        steps."""
        trainable = {n.role for n in nodes
                     if n.interface_type == ModelInterfaceType.TRAIN_STEP}
        for node in nodes:
            if (node.role not in trainable and node.is_dst_of_model_role
                    and not node._post_hooks):
                node.add_post_hook(OffloadHook())
                logger.info("Offload post-hook on %s (%s).", node.name,
                            node.role)

    def execute(self, node_name: str, inp: data_api.SequenceSample):
        """Run one MFC on its role's model: reload offloaded weights,
        the interface call, then the post-hooks (offload)."""
        node = self.nodes[node_name]
        model = self.models[node.role]
        model.engine.ensure_on_device()
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
        for h in node._post_hooks:
            if isinstance(h, OffloadHook):
                model.engine.offload()
                logger.info("Offloaded %s weights to host after %s.",
                            node.role, node_name)
        return out

    def execute_level(self, named_inputs):
        """Run one topological level's ``(node_name, inp)`` MFCs in
        order (one device: nothing to overlap yet)."""
        return [self.execute(n, i) for n, i in named_inputs]

    def save_role(self, role: str, train_node_name: str,
                  path: Optional[str] = None) -> Optional[str]:
        """Checkpoint a role into ``path`` (default
        ``run_save_path()/role``): the interface's save (the weights,
        streamed one layer at a time), then the optimizer state, one
        leaf on the host at a time. Returns the path, or None when the
        interface's ``enable_save`` is off."""
        model = self.models[role]
        itf = self.interfaces[train_node_name]
        if not getattr(itf, "enable_save", True):
            return None
        if path is None:
            path = os.path.join(constants.run_save_path(), role)
        itf.save(model, path)
        if model.engine.optimizer is not None:
            opt_checkpoint.save_opt_state_iter(
                path, model.engine.iter_opt_state_numpy())
        logger.info("Saved %s to %s", role, path)
        return path
