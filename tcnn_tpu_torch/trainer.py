"""Trainer: owns the model's parameters and the optimizer state.

PyTorch counterpart of ``tcnn_tpu/trainer.py`` (the reference's
trainer.h:47-361), in PyTorch's stateful idiom: there is no
``TrainerState`` pytree.  The model's ``nn.Parameter``s (fp32 masters)
and the optimizer's state are updated in place, and ``step`` counts the
steps taken.

  * ``training_step`` is forward, loss, backward and optimizer step
    (trainer.py:142-164); it returns the loss as a device scalar and never
    waits for the device.  It runs eagerly.
  * ``step_fn`` / ``make_training_step`` (trainer.py:166-197): the step's
    uncounted eager body for callers that capture it themselves, and the
    compiled step, which on the card replays a captured CUDA graph.
  * ``make_training_loop`` / ``training_loop`` are the counterparts of the
    JAX package's ``lax.scan`` loops: on the card they replay one captured
    CUDA graph per step (the reference's graph replay, trainer.h:176-183),
    copying each batch into the graph's static input buffers first.
  * ``inference`` and ``forward`` (trainer.py:287-299, jitted there) replay
    a captured CUDA graph per request shape on the card.
    ``invalidate_jit_cache`` drops every graph of the trainer.
  * ``serialize`` / ``deserialize`` write and read the JAX package's
    trainer dict (``utils/serialization.py``; trainer.h:275-315).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from .common import Policy
from .losses import Loss
from .module import Module
from .ops import collectives, grid_ops
from .optimizers import Optimizer


class _CapturedStep:
    """A step captured in a CUDA graph: the static buffers it reads
    (``inputs``) and the tensors it writes (``outputs``), both overwritten
    by each replay."""

    def __init__(self, graph, inputs: Tuple[torch.Tensor, ...],
                 outputs: Tuple[torch.Tensor, ...]):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs

    def replay(self, *inputs: torch.Tensor) -> None:
        """Copies ``inputs`` into the static buffers and replays the step."""
        for static, t in zip(self.inputs, inputs, strict=True):
            static.copy_(t)
        self.graph.replay()

    def __call__(self, *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``replay``, then copies of the outputs, which the next replay
        does not overwrite.  Does not wait for the device."""
        self.replay(*inputs)
        return tuple(o.clone() for o in self.outputs)


def _as_tuple(out) -> Tuple[torch.Tensor, ...]:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _captures(device) -> bool:
    """Whether the compiled entry points replay CUDA graphs on ``device``
    (the card) or run eagerly (the CPU)."""
    return torch.device(device).type == "cuda"


def _capture_step(body: Callable[..., Any], inputs: Sequence[torch.Tensor],
                  capture_error_mode: str = "global",
                  generators: Sequence[torch.Generator] = (), pool=None):
    """Captures ``body(*inputs)`` (a tensor or a tuple of tensors) in a
    CUDA graph.  Runs one real step of ``body`` eagerly on a side stream
    over static copies of ``inputs`` (the warm-up that capture needs), then
    captures the next call over the same copies; the capture runs nothing.
    ``generators`` (drawn from inside ``body``) are registered with the
    graph, so each replay draws new numbers; ``pool`` is a memory pool
    shared with other graphs (``torch.cuda.graph_pool_handle``).  The
    static copies are ordinary tensors, also under ``inference_mode``, so
    that a later call in another grad mode can fill them.  Returns the
    captured step and the warm-up's outputs as a tuple.  A failing capture
    raises: no caller goes on eagerly on the card."""
    with torch.inference_mode(False):
        static = tuple(t.clone() for t in inputs)
    device = static[0].device
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        warm = _as_tuple(body(*static))
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph, pool=pool, capture_error_mode=capture_error_mode):
        outputs = _as_tuple(body(*static))
    return _CapturedStep(graph, static, outputs), warm


class Trainer:
    def __init__(self, model: Module, optimizer: Optimizer, loss: Loss,
                 seed: int = 1337, policy: Optional[Policy] = None,
                 perturbation_sigma: Optional[float] = None):
        self.model = model
        self.optimizer = optimizer
        self.loss = loss
        self.policy = policy or model.policy
        self.seed = seed
        # Logistic output perturbation for dithering (trainer.h:114-123).
        self.perturbation_sigma = perturbation_sigma
        # The rank's noise stream under the parallel layer (0 alone).
        self.noise_stream = 0
        # Set by ``parallel.HybridParallel.shard_state``: {"n_model", "rank",
        # "model_rank"} while grid tables hold this rank's shard.
        self.shard_info: Optional[Dict[str, int]] = None
        self.step = 0
        self.opt_state = optimizer.init(self.params(), model.param_layout())
        self._noise_gen: Optional[torch.Generator] = None
        self._graphs: Dict[Tuple, _CapturedStep] = {}
        self._request_pool = None   # the requests' graphs' shared memory pool

    def params(self) -> Dict[str, torch.Tensor]:
        """The trained (fp32 master) parameters, by dotted name."""
        return dict(self.model.named_parameters())

    def n_params(self) -> int:
        return self.model.n_params()

    # -- core step ----------------------------------------------------
    def perturbation_noise(self, shape, device) -> torch.Tensor:
        """Standard logistic noise for the output perturbation.

        Drawn from a generator seeded with ``seed ^ 0x5eed`` on first use,
        so the noise of step n depends on the seed and n.  Under the
        parallel layer each rank draws its own stream: the seed is
        ``(seed ^ 0x5eed) + noise_stream · 0x9E3779B97F4A7C15`` mod 2^63
        (the odd constant moves the low 32 bits too, which are all that the
        CPU generator takes), ``noise_stream`` the
        rank's global rank (set by ``DataParallel`` and ``HybridParallel``),
        as JAX folds the mesh position into the noise key
        (``tcnn_tpu/parallel/mesh.py:122-123``); alone the stream is 0.
        PyTorch cannot reproduce JAX's random bits: tests compare
        statistics, or replace this method to inject the same noise into
        both packages.
        """
        u = torch.rand(shape, generator=self._noise_generator(device), device=device)
        return torch.log(u) - torch.log1p(-u)

    def _noise_generator(self, device) -> torch.Generator:
        if self._noise_gen is None:
            self._noise_gen = torch.Generator(device).manual_seed(
                ((self.seed ^ 0x5eed) + self.noise_stream * 0x9E3779B97F4A7C15) % 2 ** 63)
        return self._noise_gen

    def _capture_generators(self, device) -> Tuple[torch.Generator, ...]:
        """The generators a captured step draws from (the output
        perturbation's), to register with its graph."""
        return (self._noise_generator(device),) if self.perturbation_sigma else ()

    def loss_value_and_grads(self, x: torch.Tensor, target: torch.Tensor,
                             pdf: Optional[torch.Tensor] = None):
        """(loss, {name: gradient}) of the training loss at the current
        parameters (trainer.py:92-140); the parameters are not changed."""
        params = self.params()
        pred = self.model(x).float()
        if self.perturbation_sigma:
            pred = pred + self.perturbation_sigma * self.perturbation_noise(
                pred.shape, pred.device)
        loss = self.loss(pred, target, pdf)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def _step_body(self, x, target, pdf=None) -> torch.Tensor:
        loss, grads = self.loss_value_and_grads(x, target, pdf)
        self.optimizer.step(self.opt_state, grads, self.params())
        return loss

    def training_step(self, x: torch.Tensor, target: torch.Tensor,
                      pdf: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One forward + loss + backward + optimizer step
        (≈ trainer.h:163-190).  Returns the loss as a 0-d tensor on the
        model's device, without waiting for it.  It runs eagerly, so that
        it can itself be captured in a CUDA graph (a replay cannot be
        nested in a capture); JAX's counterpart is jitted, and
        ``make_training_step`` is the compiled form here."""
        loss = self._step_body(x, target, pdf)
        self.step += 1
        return loss

    def step_fn(self, *, with_pdf: bool = False) -> Callable[..., torch.Tensor]:
        """The step's eager body ``(x, target[, pdf]) -> loss``
        (trainer.py:166-173): forward, loss, backward and optimizer step,
        for callers that wrap the step in their own CUDA graph capture, as
        JAX callers wrap ``step_fn`` in their own jit.  It does not count
        the step: the caller adds one to ``step`` for each step it takes.
        ``make_training_step`` is the compiled, counted step."""
        if with_pdf:
            return self._step_body
        return lambda x, target: self._step_body(x, target)

    def make_training_step(self, *, with_pdf: bool = False, **jax_options
                           ) -> Callable[..., torch.Tensor]:
        """The compiled step (trainer.py:175-197): ``step(x, target[, pdf])
        -> loss``, each call one optimizer step, counted in ``step``.

        On the card the first call for a given set of shapes, dtypes and
        device runs the step eagerly (the warm-up) and captures the next
        one in a CUDA graph; each later call copies the batch into the
        graph's static buffers and replays it.  Each call returns a fresh
        0-d loss tensor (not the graph's, which the next replay
        overwrites) and does not wait for the device.  The graphs live in
        ``_graphs``, which ``invalidate_jit_cache`` clears: the next call
        captures anew.  Every optimizer of the package is captured, Shampoo
        too (kernel SR refreshes its roots on the device); one whose
        ``capturable`` is False raises on the card, and nothing goes on
        eagerly there.  With ``device="cpu"`` the
        steps run eagerly.  JAX's ``in_shardings``, ``out_shardings`` and
        ``donate_state`` have no counterpart here and raise ``TypeError``.
        """
        if jax_options:
            raise TypeError(f"make_training_step: {sorted(jax_options)} are JAX's "
                            f"jit options and have no counterpart in this package")
        return self._compiled_step(self.step_fn(with_pdf=with_pdf), (), with_pdf)

    def _compiled_step(self, body, key: Tuple, with_pdf: bool,
                       capture_error_mode: str = "global") -> Callable[..., torch.Tensor]:
        """``step(x, target[, pdf]) -> loss``, each call one step of
        ``body`` (uncounted), counted in ``step``: eager on the CPU; on the
        card replayed from the graph kept under ``("make_training_step",)
        + key``, the device and the batch's shapes and dtypes (``key``
        names a parallel layer, so that its graphs, which hold its
        collectives, are never this trainer's own)."""
        def run(batch: Tuple[torch.Tensor, ...]) -> torch.Tensor:
            device = batch[0].device
            if not _captures(device):
                loss = body(*batch)
            else:
                if not self.optimizer.capturable:
                    raise RuntimeError(f"make_training_step: {self.optimizer.capture_error}")
                (loss,) = self._replay(
                    ("make_training_step",) + key + (device,)
                    + tuple((tuple(t.shape), t.dtype) for t in batch),
                    body, batch, capture_error_mode, self._capture_generators(device))
            self.step += 1
            return loss

        if with_pdf:
            return lambda x, target, pdf: run((x, target, pdf))
        return lambda x, target: run((x, target))

    def _replay(self, key: Tuple, body, inputs: Sequence[torch.Tensor],
                capture_error_mode: str = "global",
                generators: Sequence[torch.Generator] = (), pool=None
                ) -> Tuple[torch.Tensor, ...]:
        """``body(*inputs)`` on the card, as a tuple: the first call for
        ``key`` runs it eagerly (the warm-up, whose outputs it returns)
        and captures it in a CUDA graph kept in ``_graphs``; later calls
        replay the graph over ``inputs`` and return copies of its
        outputs."""
        cap = self._graphs.get(key)
        if cap is None:
            self._graphs[key], out = _capture_step(body, inputs, capture_error_mode,
                                                   generators, pool)
            return out
        return cap(*inputs)

    def training_step_external_dL_dy(self, x: torch.Tensor,
                                     dL_dy: torch.Tensor) -> torch.Tensor:
        """A step driven by externally supplied output gradients instead of
        a loss (trainer.h:97-123; trainer.py:200-223).  Returns the
        prediction."""
        params = self.params()
        pred = self.model(x).float()
        grads = torch.autograd.grad(pred, list(params.values()),
                                    grad_outputs=dL_dy.float())
        self.optimizer.step(self.opt_state, dict(zip(params, grads)), params)
        self.step += 1
        return pred.detach()

    # -- multi-step loops (CUDA graph replay) ---------------------------
    def _run_loop(self, batch_fn: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
                  n_steps: int, body=None, key: Tuple = (),
                  capture_error_mode: str = "global") -> torch.Tensor:
        """``n_steps`` steps of ``body(x, target) -> loss`` (default
        ``_step_body``; the parallel layer's steps pass their own), which
        must not count the step.  Graphs are cached in ``_graphs`` by the
        batch's shapes, dtypes and device after ``key``."""
        body = body or self._step_body
        x, target = batch_fn(0)
        if _captures(x.device) and not self.optimizer.capturable:
            raise RuntimeError(f"make_training_loop: {self.optimizer.capture_error}")
        losses = torch.empty(n_steps, dtype=torch.float32, device=x.device)
        if not _captures(x.device):
            # The caller asked for the CPU: the same steps, eagerly.
            for i in range(n_steps):
                if i:
                    x, target = batch_fn(i)
                losses[i] = body(x, target)
                self.step += 1
            return losses
        key = key + (tuple(x.shape), x.dtype, tuple(target.shape), target.dtype, x.device)
        first = 0
        if key not in self._graphs:
            self._graphs[key], (warm_loss,) = _capture_step(
                body, (x, target), capture_error_mode, self._capture_generators(x.device))
            losses[0].copy_(warm_loss)
            self.step += 1
            first = 1
        cap = self._graphs[key]
        for i in range(first, n_steps):
            if i:
                x, target = batch_fn(i)
            cap.replay(x, target)
            losses[i].copy_(cap.outputs[0])
            self.step += 1
        return losses

    def make_training_loop(self, sample_fn: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
                           n_steps: int) -> Callable[[], torch.Tensor]:
        """``n_steps`` training steps per call (trainer.py:226-259).

        ``sample_fn(i)`` returns the (x, target) batch of step i on the
        model's device; it runs on the host each step and must not wait
        for the device (``ImageSampler.sample_from_pool`` draws its offsets
        on the host).  Returns ``loop() -> losses``, an (n_steps,) tensor on
        the device.  On the card the first call captures a step in a CUDA
        graph (its warm-up is the loop's first step) and every other step
        replays it; with ``device="cpu"`` the steps run eagerly.  A
        replayed step reads its step counts from the device (Shampoo
        refreshes its roots on the steps JAX does); an optimizer whose
        ``capturable`` is False raises on the card.  The captured step keeps the table-gradient route it was
        captured with (``TCNN_TPU_SCATTER=sortseg`` or not,
        ``ops/sort_scatter.py``): setting the variable later does not
        change the replays.
        """
        return lambda: self._run_loop(sample_fn, n_steps)

    def training_loop(self, xs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """One training step per pool entry of (P, B, D) stacked batches
        (trainer.py:261-278).  Returns the (P,) losses."""
        return self._run_loop(lambda i: (xs[i], targets[i]), xs.shape[0])

    # -- inference ----------------------------------------------------
    def _custom_weights(self) -> Optional[Dict[str, torch.Tensor]]:
        return self.optimizer.custom_weights(self.opt_state, self.params())

    def inference_params(self) -> Dict[str, torch.Tensor]:
        """Parameters for inference: the optimizer's custom weights
        (EMA/Average, trainer.h:329-333) if it has any, else the trained
        ones."""
        return self._custom_weights() or self.params()

    def _inference_body(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            cw = self._custom_weights()
            if cw is None:
                return self.model.inference(x)
            return torch.func.functional_call(self.model, cw, (x,))

    def _forward_body(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.model(x)

    def _request(self, body, x: torch.Tensor, key: Tuple,
                 capture_error_mode: str = "global") -> torch.Tensor:
        """``body(x)``, a request.  Eager on the CPU, and where the current
        stream is capturing already: a replay cannot be nested in a
        capture, so the outer graph records the body itself.  On the card
        the first call for ``key`` and x's device, shape and dtype captures
        the body; later calls copy x into the graph's input buffer and
        replay it.  The requests' graphs share one memory pool: they never
        run at once, and each call returns a fresh tensor, never a graph's
        own output buffer."""
        if not _captures(x.device) or torch.cuda.is_current_stream_capturing():
            return body(x)
        if self._request_pool is None:
            self._request_pool = torch.cuda.graph_pool_handle()
        (y,) = self._replay(key + (x.device, tuple(x.shape), x.dtype), body, (x,),
                            capture_error_mode, pool=self._request_pool)
        return y

    def _trainer_request(self, entry: str, body, x: torch.Tensor) -> torch.Tensor:
        """``_request`` of ``inference`` or ``forward``; the route, the grid
        tables' sharding (``grid_ops.sharded_tables``), is part of the
        key: a graph captured unsharded is never replayed sharded."""
        sharding = grid_ops.table_sharding()
        if sharding is None:
            return self._request(body, x, (entry, None))
        collectives.check_capturable([sharding.group], x.device, f"Trainer.{entry}",
                                     "the model's own forward runs eagerly")
        return self._request(body, x, (entry, sharding), collectives.CAPTURE_MODE)

    def inference(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n_input_dims) → (B, n_output_dims) in the policy's output
        dtype, with the inference parameters, as an inference tensor: the
        compiled request (trainer.py:287-293).  On the card the first call
        for a given shape, dtype, device and route captures the request in
        a CUDA graph and later calls replay it (``_request``).  The graph
        reads the live parameters and optimizer state, and computes the
        custom weights (EMA, Average) from that state, so training between
        requests shows in the next one.  On the CPU it runs eagerly."""
        with torch.inference_mode():
            return self._trainer_request("inference", self._inference_body, x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The model's output with the trained parameters, without gradient
        bookkeeping (no grad; trainer.py:295-299): compiled on the card as
        ``inference`` is."""
        with torch.no_grad():
            return self._trainer_request("forward", self._forward_body, x)

    def evaluate_loss(self, x: torch.Tensor, target: torch.Tensor,
                      pdf: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The loss of ``forward``'s output (a compiled request on the card)."""
        return self.loss(self.forward(x).float(), target, pdf)

    # -- runtime hyperparameters ---------------------------------------
    def update_hyperparams(self, cfg: Dict[str, Any]) -> None:
        """Runtime update of loss/optimizer hyperparameters
        (trainer.h:213-224).  Captured graphs hold the old values as
        constants, so they are dropped and captured anew."""
        if "optimizer" in cfg:
            self.optimizer.update_hyperparams(cfg["optimizer"])
        if "loss" in cfg:
            self.loss.update_hyperparams(cfg["loss"])
        self.invalidate_jit_cache()

    def invalidate_jit_cache(self) -> None:
        """Drops every CUDA graph captured for this trainer (trainer.py:
        316-321 drops the jitted closures): its compiled steps, loops and
        requests, and the parallel layer's.  The next call captures anew.
        A graph holds the addresses of the parameters and the optimizer
        state: whatever rebinds them calls this (``HybridParallel.
        shard_state``); the in-place loads (``deserialize``,
        ``restore_checkpoint``, ``import_params``) keep the graphs valid.
        Call it before ``torch.distributed.destroy_process_group``: a graph
        that holds NCCL collectives must go before its communicators."""
        self._graphs.clear()
        self._request_pool = None

    # -- checkpointing ------------------------------------------------
    def serialize(self, serialize_optimizer: bool = True,
                  state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The JAX package's trainer dict (``utils/serialization.py``), of
        this trainer's state or of ``state``, a canonical tree that
        ``HybridParallel.gather_state`` returns."""
        from .utils import serialization

        return serialization.serialize_trainer(self, serialize_optimizer, state)

    def deserialize(self, data: Dict[str, Any]) -> None:
        """Loads a trainer dict of either package into this trainer's
        parameters, optimizer state and step, in place."""
        from .utils import serialization

        serialization.deserialize_trainer(self, data)
