"""Model hosting for the inline runner: one engine per model role, on
one device or the members of a pipeline-, data- and tensor-parallel
layout (with an optimizer for the roles that train), or, for a role
that no MFC trains, on the members of a context-parallel layout (its
generation runs on the engine's decode view); one replica engine per
MFC whose allocation (``ExperimentSpec.allocations``) differs from its
role's layout, kept fresh by parameter reallocation (an allocation that
only adds a decode degree ``g`` is not a replica: it sets the engine's
``gen_tp_size``); the algorithm interfaces of the MFCs, MFC execution
(with ``drop_decode_view_after_rollout`` after each generate MFC), and
each role's checkpoint (weights and optimizer state)."""

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import torch

from realhf_tpu_torch.api import data as data_api
from realhf_tpu_torch.api import model as model_api
from realhf_tpu_torch.api.config import ModelInterfaceType, ModelName
from realhf_tpu_torch.api.dfg import MFCDef, OffloadHook, ParamReallocHook
from realhf_tpu_torch.base import constants, logging, seeding
from realhf_tpu_torch.base.device import DeviceLike, resolve_device
from realhf_tpu_torch.engine import opt_checkpoint
from realhf_tpu_torch.engine.engine import Engine, _tree_map
from realhf_tpu_torch.models import hf
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.parallel.mesh import default_devices
from realhf_tpu_torch.parallel.realloc import ReplicaManager

logger = logging.getLogger("model_host", "benchmark")


def build_model(role: str, spec, tokenizer, init_seed: int,
                device: DeviceLike = None,
                total_steps: Optional[int] = None,
                devices: Optional[Sequence[DeviceLike]] = None
                ) -> model_api.Model:
    """Instantiate one model role on ``device`` (None = the CUDA card):
    its weights from the HF-layout checkpoint at ``spec.path`` (streamed
    one layer at a time onto the device, the host holding one layer plus
    the embeddings), else drawn from (experiment seed, role); and its
    optimizer when the spec has one (``total_steps`` sizes the learning
    rate schedule), with the state saved beside the checkpoint when
    ``spec.restore_optimizer_state``.

    A layout of more than one device (``spec.parallel``) builds over
    ``devices`` (default ``cuda:0 .. n-1``, or n times the CPU when
    ``device`` is the CPU): every ``dNcCtMpP[s]`` layout, trained or not,
    but c with p (``parallel/mesh.check_layout`` raises)."""
    par = spec.parallel
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


def build_replica(primary: model_api.Model, par,
                  device: DeviceLike = None,
                  devices: Optional[Sequence[DeviceLike]] = None
                  ) -> model_api.Model:
    """A replica of ``primary`` (its config and weights, no optimizer)
    on layout ``par``. The replica holds weights of its own: an engine
    of one tree would keep the tensors it is given, so it gets a copy
    (a reallocation, an EMA merge above all, must never write into the
    primary's tensors; a layout of several members places its own
    copies)."""
    role = primary.name.role
    src = primary.engine
    params = src.params
    if par.world_size == 1:
        tree = src.gathered_params() if src.sharded else params
        params = _tree_map(torch.clone, tree)
    engine = Engine(dataclasses.replace(primary.config), params, device,
                    parallel=par, devices=devices)
    return model_api.Model(ModelName(role, 0), engine, primary.tokenizer,
                           hf_family=primary.hf_family)


class ModelHost:
    """The models of some roles, their MFCs' replicas, and MFC
    execution.

    ``role_devices`` names the devices of a role with a layout of more
    than one device (the JAX package's ``devices_fn``); a role it does
    not name takes ``build_model``'s default. ``devices`` are the
    runner's devices, which an ``MFCAllocation``'s ``device_ids`` index
    (default: every card, or the CPU); a replica without ``device_ids``
    takes its role's devices when their number fits its layout, else
    the first of the runner's devices, else the layout's default."""

    def __init__(self, spec, roles: List[str], nodes: List[MFCDef],
                 tokenizer, device: DeviceLike = None,
                 total_steps: Optional[int] = None,
                 role_devices: Optional[Dict[str, Sequence[DeviceLike]]]
                 = None,
                 devices: Optional[Sequence[DeviceLike]] = None):
        self.spec = spec
        self.nodes = {n.name: n for n in nodes}
        self.role_devices = dict(role_devices or {})
        self.device = device
        self.devices = (None if devices is None
                        else [torch.device(d) for d in devices])
        self.models = {
            role: build_model(role, spec.models[role], tokenizer,
                              init_seed=spec.seed, device=device,
                              total_steps=total_steps,
                              devices=self.role_devices.get(role))
            for role in roles
        }
        #: MFC name -> the replica its allocation runs on
        self.replicas: Dict[str, model_api.Model] = {}
        self.replica_mgr = ReplicaManager()
        for node in nodes:
            alloc = spec.alloc_of(node.name)
            if alloc is None or node.role not in self.models:
                continue
            primary = self.models[node.role]
            if (alloc.parallel.same_layout(primary.engine.parallel)
                    and alloc.device_ids is None):
                # the role's own layout: not a replica; a ``g`` reaches
                # the engine's decode view
                self._install_gen_tp(primary, alloc.parallel, node.name)
                continue
            if node.interface_type == ModelInterfaceType.TRAIN_STEP:
                raise ValueError(
                    f"MFC {node.name}: train MFCs run on the role's own "
                    "layout (replicas have no optimizer).")
            self.replicas[node.name] = build_replica(
                primary, alloc.parallel, device=device,
                devices=self._alloc_devices(alloc, node.role))
            logger.info("Created replica for %s: %s (primary %s)",
                        node.name, alloc.parallel, primary.engine.parallel)
        self.interfaces = {n.name: model_api.make_interface(n.interface_impl)
                           for n in nodes}
        if spec.auto_offload:
            self._resolve_offload_hooks(nodes)

    def _runner_devices(self) -> List:
        if self.devices is not None:
            return self.devices
        dev = resolve_device(self.device)
        if dev.type == "cpu":
            return [dev]
        return default_devices(torch.cuda.device_count())

    def _alloc_devices(self, alloc, role: str):
        n = alloc.parallel.world_size
        base = self._runner_devices()
        if alloc.device_ids is not None:
            if len(alloc.device_ids) != n:
                raise ValueError(
                    f"device_ids {alloc.device_ids} for a layout of {n}")
            if base[0].type == "cpu":
                return [base[0]] * n
            if any(i >= len(base) for i in alloc.device_ids):
                raise ValueError(f"device_ids {alloc.device_ids} out of "
                                 f"range for {len(base)} devices")
            return [base[i] for i in alloc.device_ids]
        own = self.role_devices.get(role)
        if own is not None and len(own) == n:
            return list(own)
        if self.devices is not None and len(self.devices) >= n:
            return self.devices[:n]
        return None

    @staticmethod
    def _install_gen_tp(model, par, node_name: str):
        """An allocation that differs from the role's layout only by
        ``gen_tp_size`` sets the engine's decode degree (the weight
        layout is the same)."""
        eng = model.engine
        cur = eng.parallel.gen_tp_size
        if not par.gen_tp_size or par.gen_tp_size == cur:
            return
        if cur:
            logger.warning("MFC %s sets gen_tp_size=%d over an engine at "
                           "gen_tp_size=%d; the last one wins.", node_name,
                           par.gen_tp_size, cur)
        eng.set_gen_tp(par.gen_tp_size)

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
        """Run one MFC on its role's model or its replica: reload
        offloaded weights, refresh a replica from the role's primary
        when the primary's version moved (``eta`` from a
        ``ParamReallocHook`` pre-hook), the interface call, then the
        post-hooks (offload)."""
        node = self.nodes[node_name]
        primary = self.models[node.role]
        model = self.replicas.get(node_name, primary)
        model.engine.ensure_on_device()
        if model is not primary:
            eta = next((h.eta for h in node._pre_hooks
                        if isinstance(h, ParamReallocHook)
                        and h.eta is not None), 1.0)
            self.replica_mgr.ensure_fresh(node.role, primary, model,
                                          eta=eta)
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
        if (node.interface_type == ModelInterfaceType.GENERATE
                and self.spec.models[node.role]
                .drop_decode_view_after_rollout):
            freed = model.engine.decode_view_param_bytes()
            model.engine.drop_decode_view()
            if freed:
                logger.info("Dropped %s's decode view after %s (%.2f GB).",
                            node.role, node_name, freed / 2 ** 30)
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
