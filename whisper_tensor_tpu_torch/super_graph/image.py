"""Diffusion text-to-image SuperGraph builder.

Reference equivalent: ImageGenerationInterface builds its denoise loop
as a SuperGraph Scan (src/interfaces.rs:327-2780) so the WebUI can ship
the whole job as a serializable graph and stream every intermediate.

TPU note (same split as super_graph/llm.py): this graph is the
*introspectable* path — each denoise step executes as a node, tensors
stream through observers, cancellation checks run between steps. The
throughput path is interfaces.image_gen's FUSED lax.scan denoise
program. Both drive identical model graphs.

The port's copy of whisper_tensor_tpu/super_graph/image.py (:25-201).
In torch mode the UNet, the text encoder and the VAE run through
`EvalBackend.run_on_device` (super_graph/graph.py), the latents are made
on the host from the seed, as the reference makes them, and then stay on
the device between steps, and the CFG combine and the Euler or
rectified-flow update run there in f32. The update's coefficients are
the reference's (python floats, or f32 where the reference rounds to
f32), so one expression serves numpy arrays and torch tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dtype import to_device
from .graph import SuperGraph
from .links import LinkKind
from .nodes import (ScanNode, SuperNode, TensorToImageNode, host_value,
                    register_node)


def _cat(xs):
    """Concatenate on axis 0: torch.cat for tensors, np.concatenate
    otherwise."""
    if isinstance(xs[0], torch.Tensor):
        return torch.cat(xs, dim=0)
    return np.concatenate(xs, axis=0)


def _f32(x):
    """x as f32: a tensor stays on its device."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return np.asarray(x, dtype=np.float32)


@register_node
class DiffusionStepNode(SuperNode):
    """One denoise step: UNet (CFG pair) + scheduler update.

    in: 'state' (tensor map: latents + step index)
    out: 'state' (updated), 'latents' (post-step latents, for
         per-step introspection/preview)
    params: model_ref, sigmas (list), timesteps (list),
            guidance_scale, schedule ('euler'|'rectified_flow'),
            prediction_type ('epsilon'|'v_prediction')
    """

    def execute(self, ctx, ins):
        from ..interfaces.image_gen import euler_scaled

        state = dict(ins["state"])
        lat = _f32(state["latents"])
        i = int(host_value(state["i"]))
        sigmas = self.params["sigmas"]
        sig = float(sigmas[i])
        t = float(self.params["timesteps"][i])
        g = float(self.params["guidance_scale"])
        schedule = self.params.get("schedule", "euler")
        model = ctx.models[self.params["model_ref"]]
        scaled = euler_scaled(lat, sig) if schedule == "euler" else lat
        sample = _cat([scaled, scaled])
        feeds = {"sample": sample, "timestep": np.asarray(t, np.float32),
                 "encoder_hidden_states": state["ctx"]}
        out = _f32(ctx.run_model(model, feeds)["out"])
        eps = out[0:1] + g * (out[1:2] - out[0:1])
        if schedule == "euler":
            if self.params.get("prediction_type") == "v_prediction":
                c1 = float(np.float32(-sig / np.sqrt(sig * sig + 1.0)))
                c2 = float(np.float32(1.0 / (sig * sig + 1.0)))
                pred_x0 = eps * c1 + lat * c2
            else:
                pred_x0 = lat - sig * eps
            d = (lat - pred_x0) / sig
            lat = lat + d * (float(sigmas[i + 1]) - sig)
        else:
            lat = lat + (float(sigmas[i + 1]) - sig) * eps
        new_state = dict(state)
        new_state["latents"] = lat
        new_state["i"] = np.asarray(i + 1, np.int64)
        return {"state": new_state, "latents": lat}


@register_node
class EncodeCfgNode(SuperNode):
    """CLIP text encode of prompt + negative, concatenated CFG pair.

    params: model_ref — ExecutionContext name of the text encoder."""

    def execute(self, ctx, ins):
        te = ctx.models[self.params["model_ref"]]
        cond = ctx.run_model(
            te, {"input_ids": np.asarray(host_value(ins["ids"]), np.int64)})[
            "last_hidden_state"]
        uncond = ctx.run_model(
            te, {"input_ids": np.asarray(host_value(ins["nids"]), np.int64)})[
            "last_hidden_state"]
        return {"ctx": _cat([uncond, cond])}


@register_node
class InitLatentsNode(SuperNode):
    """Seeded gaussian latents, scaled by sigma0 for euler schedules.

    params: seed, channels, hw, schedule, sigma0."""

    def execute(self, ctx, ins):
        rng = np.random.default_rng(self.params["seed"])
        lat = rng.standard_normal(
            (1, self.params["channels"],) + tuple(self.params["hw"])
        ).astype(np.float32)
        if self.params["schedule"] == "euler":
            lat = lat * np.float32(self.params["sigma0"])
        if ctx.backend_mode == "torch":
            lat = to_device(lat, ctx.device)
        return {"state": {"latents": lat,
                          "i": np.asarray(0, np.int64),
                          "ctx": ins["ctx"]}}


@register_node
class ConstNode(SuperNode):
    """Emit params['value'] as an int64 scalar (Scan iteration count)."""

    def execute(self, ctx, ins):
        return {"value": np.asarray(self.params["value"], np.int64)}


@register_node
class VaeDecodeNode(SuperNode):
    """Final latents -> VAE decode -> (1,C,H,W) image tensor in [-1,1].

    params: model_ref — ExecutionContext name of the VAE decoder."""

    def execute(self, ctx, ins):
        lat = _f32(ins["state"]["latents"])
        img = ctx.run_model(
            ctx.models[self.params["model_ref"]], {"latents": lat})["image"]
        return {"tensor": img}


def build_diffusion_supergraph(text_encoder: str, unet: str, vae: str,
                               steps: int, guidance_scale: float = 7.5,
                               latent_channels: int = 4,
                               latent_hw=(64, 64), seed: int = 0,
                               schedule: str = "euler",
                               prediction_type: str = "epsilon",
                               bos_token_id: int = 49406,
                               eos_token_id: int = 49407,
                               seq_len: int = 77) -> SuperGraph:
    """prompt ids -> CFG conditioning -> Scan(denoise) -> VAE -> Image.

    Model names are ExecutionContext refs (like build_llm_supergraph).
    Takes 'prompt_ids' and 'negative_ids' tensor inputs (pre-tokenized,
    padded to seq_len) so the graph is tokenizer-agnostic."""
    from ..interfaces.image_gen import (euler_discrete_schedule,
                                        rectified_flow_schedule)

    sched = (euler_discrete_schedule(steps) if schedule == "euler"
             else rectified_flow_schedule(steps))
    sigmas = [float(x) for x in sched["sigmas"]]
    timesteps = [float(x) for x in sched["timesteps"]]

    g = SuperGraph("diffusion")
    ids_in = g.mark_input("prompt_ids", g.link(LinkKind.TENSOR, "prompt_ids"))
    nids_in = g.mark_input("negative_ids",
                           g.link(LinkKind.TENSOR, "negative_ids"))
    ctx_l = g.link(LinkKind.TENSOR, "cfg_context")
    state0_l = g.link(LinkKind.TENSOR_MAP, "denoise_state0")
    final_l = g.link(LinkKind.TENSOR_MAP, "denoise_final")
    img_t_l = g.link(LinkKind.TENSOR, "image_tensor")
    img_l = g.link(LinkKind.IMAGE, "image")

    g.add(EncodeCfgNode(inputs={"ids": ids_in, "nids": nids_in},
                        outputs={"ctx": ctx_l}, model_ref=text_encoder))

    g.add(InitLatentsNode(inputs={"ctx": ctx_l},
                          outputs={"state": state0_l},
                          seed=seed, channels=latent_channels,
                          hw=list(latent_hw), schedule=schedule,
                          sigma0=sigmas[0]))

    body = SuperGraph("denoise_body")
    b_in = body.mark_input("state", body.link(LinkKind.TENSOR_MAP))
    b_out = body.link(LinkKind.TENSOR_MAP)
    # named so observers can stream every step's latents (the WebUI's
    # live per-step preview; reference sd_explorer.rs)
    b_lat = body.link(LinkKind.TENSOR, "step_latents")
    body.add(DiffusionStepNode(
        inputs={"state": b_in}, outputs={"state": b_out, "latents": b_lat},
        model_ref=unet, sigmas=sigmas, timesteps=timesteps,
        guidance_scale=guidance_scale, schedule=schedule,
        prediction_type=prediction_type))
    body.mark_output("state_out", b_out)
    body.mark_output("latents", b_lat)

    n_l = g.link(LinkKind.TENSOR, "n_steps")
    g.add(ConstNode(outputs={"value": n_l}, value=steps))
    traj_l = g.link(LinkKind.TENSOR, "latent_trajectory")
    scan = ScanNode(inputs={"state": state0_l, "n_iters": n_l},
                    outputs={"final_state": final_l, "traj": traj_l},
                    state=[("state", "state", "state_out")],
                    scan_inputs=[], scan_outputs=[("latents", "traj", 0)],
                    body=None)
    scan.body = body
    g.add(scan)

    g.add(VaeDecodeNode(inputs={"state": final_l},
                        outputs={"tensor": img_t_l}, model_ref=vae))
    g.add(TensorToImageNode(inputs={"tensor": img_t_l},
                            outputs={"image": img_l}))
    g.mark_output("image", img_l)
    g.mark_output("latent_trajectory", traj_l)
    g.validate()
    return g
