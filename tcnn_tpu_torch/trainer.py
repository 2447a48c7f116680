"""Trainer: owns the model's parameters and the optimizer state.

PyTorch counterpart of ``tcnn_tpu/trainer.py`` (the reference's
trainer.h:47-361), in PyTorch's stateful idiom: there is no
``TrainerState`` pytree.  The model's ``nn.Parameter``s (fp32 masters)
and the optimizer's state are updated in place, and ``step`` counts the
steps taken.

  * ``training_step`` is forward, loss, backward and optimizer step
    (trainer.py:142-164); it returns the loss as a device scalar and never
    waits for the device.
  * ``make_training_loop`` / ``training_loop`` are the counterparts of the
    JAX package's ``lax.scan`` loops: on the card they replay one captured
    CUDA graph per step (the reference's graph replay, trainer.h:176-183),
    copying each batch into the graph's static input buffers first.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .common import Policy
from .losses import Loss
from .module import Module
from .optimizers import Optimizer


class _CapturedStep:
    """One training step captured in a CUDA graph, with its static buffers."""

    def __init__(self, graph, x, target, loss):
        self.graph, self.x, self.target, self.loss = graph, x, target, loss


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
        self.step = 0
        self.opt_state = optimizer.init(self.params(), model.param_layout())
        self._noise_gen: Optional[torch.Generator] = None
        self._graphs: Dict[Tuple, _CapturedStep] = {}

    def params(self) -> Dict[str, torch.Tensor]:
        """The trained (fp32 master) parameters, by dotted name."""
        return dict(self.model.named_parameters())

    def n_params(self) -> int:
        return self.model.n_params()

    # -- core step ----------------------------------------------------
    def perturbation_noise(self, shape, device) -> torch.Tensor:
        """Standard logistic noise for the output perturbation.

        Drawn from a generator seeded with ``seed ^ 0x5eed`` on first use,
        so the noise of step n depends on the seed and n.  PyTorch cannot
        reproduce JAX's random bits: tests compare statistics, or replace
        this method to inject the same noise into both packages.
        """
        if self._noise_gen is None:
            self._noise_gen = torch.Generator(device).manual_seed(self.seed ^ 0x5eed)
        u = torch.rand(shape, generator=self._noise_gen, device=device)
        return torch.log(u) - torch.log1p(-u)

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
        model's device, without waiting for it."""
        loss = self._step_body(x, target, pdf)
        self.step += 1
        return loss

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
    def _capture(self, x: torch.Tensor, target: torch.Tensor):
        """Runs one real step eagerly on a side stream (the warm-up that
        capture needs), then captures the next step into a CUDA graph that
        reads the static ``x``/``target`` buffers.  Returns the captured
        step and the loss of the eager one.  A failing capture raises: the
        loop never goes on eagerly on the card."""
        static_x, static_t = x.clone(), target.clone()
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            warm_loss = self.training_step(static_x, static_t)
        torch.cuda.current_stream(x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.perturbation_sigma:
            graph.register_generator_state(self._noise_gen)
        with torch.cuda.graph(graph):
            loss = self._step_body(static_x, static_t)
        return _CapturedStep(graph, static_x, static_t, loss), warm_loss

    def _run_loop(self, batch_fn: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
                  n_steps: int) -> torch.Tensor:
        x, target = batch_fn(0)
        losses = torch.empty(n_steps, dtype=torch.float32, device=x.device)
        if x.device.type != "cuda":
            # The caller asked for the CPU: the same steps, eagerly.
            for i in range(n_steps):
                if i:
                    x, target = batch_fn(i)
                losses[i] = self.training_step(x, target)
            return losses
        key = (tuple(x.shape), x.dtype, tuple(target.shape), target.dtype, x.device)
        first = 0
        if key not in self._graphs:
            self._graphs[key], warm_loss = self._capture(x, target)
            losses[0].copy_(warm_loss)
            first = 1
        cap = self._graphs[key]
        for i in range(first, n_steps):
            if i:
                x, target = batch_fn(i)
            cap.x.copy_(x)
            cap.target.copy_(target)
            cap.graph.replay()
            losses[i].copy_(cap.loss)
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
        replays it; with ``device="cpu"`` the steps run eagerly.
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

    def inference(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n_input_dims) → (B, n_output_dims) in the policy's output
        dtype, with the inference parameters, without gradient
        bookkeeping."""
        with torch.inference_mode():
            cw = self._custom_weights()
            if cw is None:
                return self.model.inference(x)
            return torch.func.functional_call(self.model, cw, (x,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The model's output with the trained parameters."""
        with torch.no_grad():
            return self.model(x)

    def evaluate_loss(self, x: torch.Tensor, target: torch.Tensor,
                      pdf: Optional[torch.Tensor] = None) -> torch.Tensor:
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
        self._graphs.clear()
