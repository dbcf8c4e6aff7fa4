"""The training diffusion (iDDPM flavour); port of
pixart_sigma_tpu/diffusion/factory.py."""

from __future__ import annotations

from pixart_sigma_tpu_torch.diffusion.gaussian import LossType, ModelMeanType, ModelVarType
from pixart_sigma_tpu_torch.diffusion.respace import SpacedDiffusion, space_timesteps
from pixart_sigma_tpu_torch.diffusion.schedules import named_beta_schedule


def IDDPM(
    timestep_respacing=None,
    noise_schedule: str = "linear",
    sigma_small: bool = False,
    predict_xstart: bool = False,
    learn_sigma: bool = True,
    pred_sigma: bool = True,
    rescale_learned_sigmas: bool = False,
    diffusion_steps: int = 1000,
    snr: bool = False,
) -> SpacedDiffusion:
    """A SpacedDiffusion configured like the reference's IDDPM(): learned
    range variance, or with learn_sigma=False a fixed one (small with
    sigma_small); `snr` switches the MSE target to x0 for t <= 249. Its use_kl
    switch is not ported (ROADMAP.md, Queue 1 item 8)."""
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    if not pred_sigma:
        var_type = None
    elif learn_sigma:
        var_type = ModelVarType.LEARNED_RANGE
    else:
        var_type = ModelVarType.FIXED_SMALL if sigma_small else ModelVarType.FIXED_LARGE
    return SpacedDiffusion.from_betas(
        betas=named_beta_schedule(noise_schedule, diffusion_steps),
        use_timesteps=space_timesteps(diffusion_steps, timestep_respacing),
        model_mean_type=ModelMeanType.START_X if predict_xstart else ModelMeanType.EPSILON,
        model_var_type=var_type,
        loss_type=LossType.RESCALED_MSE if rescale_learned_sigmas else LossType.MSE,
        snr=snr,
    )
