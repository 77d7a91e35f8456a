"""Learned-dynamics predictors: MLP and stacked GRU/LSTM networks
(counterpart of control_toolkit_tpu/models/neural_predictor.py).

The reference selects a trained network by name in
``predictor_specification`` (e.g. 'GRU-6IN-32H1-32H2-5OUT-0') and drives
it through predict_core/update.  An MLP predictor models ``x' = x +
net([x, u])`` (delta form) or ``x' = net([x, u])``, with the checkpoint's
``norm_in_*`` / ``norm_out_*`` statistics applied around the net.  A
recurrent predictor carries a persistent batch-1 hidden state that
``update`` advances with the applied control and that every rollout
starts from, broadcast to the K rollouts.

The weights and the hidden are tensors on the predictor's ``device`` (the
controller's): the optimizer step reads them as ``params["dyn"]`` =
``{"net": ..., "hidden": ...}``, so a new weight tensor or an advanced
hidden reaches the next step without rebuilding anything, and the hidden
is advanced on the device.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import torch

from control_toolkit_tpu_torch.models import networks as nets
from control_toolkit_tpu_torch.models.dynamics import DYNAMICS
from control_toolkit_tpu_torch.models.predictors import Predictor, scan_rollout
from control_toolkit_tpu_torch.utils import registry
from control_toolkit_tpu_torch.utils.device import place, resolve_device

logger = logging.getLogger(__name__)

COMPUTE_DTYPES = {"float32": torch.float32, "f32": torch.float32,
                  "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


@registry.predictors.register("neural")
class NeuralPredictor(Predictor):
    def __init__(
        self,
        environment_name: str = "cartpole",
        dt: float = 0.02,
        net_name: str = "mlp-64-64",
        num_states: Optional[int] = None,
        num_control_inputs: Optional[int] = None,
        path_to_models: Optional[str] = None,
        predict_delta: bool = True,
        seed: int = 0,
        params: Optional[Dict] = None,
        compute_dtype: str = "float32",
        device: Optional[torch.device] = None,
        **kwargs,
    ):
        self.environment_name = environment_name.lower()
        if num_states is None or num_control_inputs is None:
            _, _, s_def, u_def = DYNAMICS[self.environment_name]
            num_states = s_def if num_states is None else num_states
            num_control_inputs = u_def if num_control_inputs is None else num_control_inputs
        self.num_states = int(num_states)
        self.num_control_inputs = int(num_control_inputs)
        self.dt = float(dt)
        self.net_name = net_name
        self.predict_delta = bool(predict_delta)
        self.device = resolve_device(device)
        self.arch = nets.parse_net_name(net_name)
        self.recurrent = self.arch["kind"] in nets.RECURRENT_FNS
        if self.recurrent:
            self._rnn_init, self._rnn_apply, self._rnn_state0 = nets.RECURRENT_FNS[self.arch["kind"]]
        # bf16 evaluates the network in bfloat16 on the loop path only; the
        # state residual x + net(x, u) stays float32.  The kernels compute in
        # float32, so a bf16 predictor keeps the loop (kernel_families/neural.py).
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
        self.compute_dtype = COMPUTE_DTYPES[compute_dtype]

        in_dim = self.num_states + self.num_control_inputs
        if params is not None:
            self.net_params = place(params, self.device)
        else:
            ckpt = Path(path_to_models or ".") / f"{net_name}.npz"
            if ckpt.is_file():
                net, meta = nets.load_net(ckpt)
                self.net_params = place(net, self.device)
                self.predict_delta = bool(meta.get("predict_delta", predict_delta))
                logger.info(f"loaded dynamics net {net_name} from {ckpt}")
            else:
                generator = torch.Generator().manual_seed(int(seed))
                if self.recurrent:
                    net = self._rnn_init(generator, in_dim, self.arch["hiddens"], self.num_states)
                else:
                    sizes = [in_dim] + list(self.arch["hiddens"]) + [self.num_states]
                    net = nets.mlp_init(generator, sizes)
                self.net_params = place(net, self.device)
                logger.warning(f"no checkpoint for dynamics net {net_name}; random init")
        if self.recurrent:
            self.reset_state()

    @property
    def is_stateful(self) -> bool:
        return self.recurrent

    def default_params(self) -> Dict:
        # The live hidden rides in the params, so each step reads the
        # current one.
        if self.recurrent:
            return {"net": self.net_params, "hidden": self.hidden}
        return {"net": self.net_params}

    # ---- single transition (MLP only) -------------------------------------
    @property
    def single_step(self):
        if self.recurrent:
            return None  # the hidden threads through the rollout instead
        cdt = self.compute_dtype

        def step(x, u, p):
            net = p["net"]
            inp = torch.cat([x, u], dim=-1)
            if "norm_in_mean" in net:
                inp = (inp - net["norm_in_mean"]) / net["norm_in_std"]
            core = {k: v for k, v in net.items() if not k.startswith("norm_")}
            if cdt != torch.float32:
                core = {k: v.to(cdt) for k, v in core.items()}
                inp = inp.to(cdt)
            out = nets.mlp_apply(core, inp).float()
            if "norm_out_mean" in net:
                out = out * net["norm_out_std"] + net["norm_out_mean"]
            return x + out if self.predict_delta else out

        return step

    def _cast_net(self, net: Dict) -> Dict:
        if self.compute_dtype == torch.float32:
            return net
        return {k: self._cast_net(v) if isinstance(v, dict) else v.to(self.compute_dtype)
                for k, v in net.items()}

    def rollout(self, s0, Q, params=None):
        p = self.default_params() if params is None else params
        if not self.recurrent:
            return scan_rollout(self.single_step, s0, Q, p)
        # The hidden must come from the params: the step reads the live one.
        cdt = self.compute_dtype
        net = self._cast_net(p["net"])
        B = s0.shape[0]
        hs = tuple(h.to(cdt).expand(B, h.shape[-1]) for h in p["hidden"])
        x, xs = s0, [s0]
        for h in range(Q.shape[1]):
            out, hs = self._rnn_apply(net, torch.cat([x, Q[:, h, :]], dim=-1).to(cdt), hs)
            out = out.float()
            x = x + out if self.predict_delta else out
            xs.append(x)
        return torch.stack(xs, dim=1)

    def update(self, s, Q0, params=None) -> None:
        """Advance the persistent hidden with the applied control (the
        reference's predictor.update), on the hidden's device."""
        if not self.recurrent:
            return
        net = self.net_params if params is None else params["net"]
        x = s[:1]
        u = Q0.reshape(1, -1)[:, : self.num_control_inputs]
        _, self.hidden = self._rnn_apply(net, torch.cat([x, u], dim=-1), self.hidden)

    def reset_state(self) -> None:
        if self.recurrent:
            self.hidden = self._rnn_state0(self.arch["hiddens"], 1, device=self.device)

    def copy(self) -> "NeuralPredictor":
        new = NeuralPredictor(
            environment_name=self.environment_name, dt=self.dt, net_name=self.net_name,
            num_states=self.num_states, num_control_inputs=self.num_control_inputs,
            predict_delta=self.predict_delta, params=self.net_params,
            compute_dtype="bfloat16" if self.compute_dtype == torch.bfloat16 else "float32",
            device=self.device,
        )
        if self.recurrent:
            # A copy made mid-run sees the same accumulated hidden.
            new.hidden = self.hidden
        return new
