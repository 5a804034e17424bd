"""Typed configurations of the port from the YAML ``Settings`` tree.

The port of ``loner_tpu/config/build.py``: the same cfg/ files build the
port's ``SlamConfig`` field for field. The hash-encoding blocks map to the
port's ``HashEncodingConfig`` (the default field is the gather-free triad,
which reads only its table size).
"""
from __future__ import annotations

from loner_tpu_torch.config.settings import Settings
from loner_tpu_torch.mapping.keyframe_manager import KeyFrameManagerConfig
from loner_tpu_torch.mapping.mapper import IterationPhase, OnlineMapperConfig, SchedulePhase
from loner_tpu_torch.mapping.optimizer import MapperConfig
from loner_tpu_torch.models.losses import LossConfig
from loner_tpu_torch.models.nerf import HashEncodingConfig, NeRFConfig
from loner_tpu_torch.models.occupancy_grid import OccGridConfig
from loner_tpu_torch.runtime.debug_dump import DebugFlags
from loner_tpu_torch.slam import LoopClosureConfig, SlamConfig
from loner_tpu_torch.tracking.frame_synthesis import FrameSynthesisConfig
from loner_tpu_torch.tracking.icp import IcpConfig, IcpStage
from loner_tpu_torch.tracking.tracker import TrackerConfig


def build_hash_config(s: Settings) -> HashEncodingConfig:
    return HashEncodingConfig(
        n_levels=s.n_levels,
        n_features_per_level=s.n_features_per_level,
        log2_hashmap_size=s.log2_hashmap_size,
        base_resolution=s.base_resolution,
        per_level_scale=s.get("per_level_scale", 2.0),
    )


def build_nerf_config(model: Settings) -> NeRFConfig:
    nerf = model.nerf_config
    return NeRFConfig(
        num_colors=model.num_colors,
        enable_view_dependence=nerf.enable_view_dependence,
        sh_degree=nerf.dir_encoding_intensity.degree,
        pos_encoding_sigma=build_hash_config(nerf.pos_encoding_sigma),
        pos_encoding_intensity=build_hash_config(nerf.pos_encoding_intensity),
        sigma_hidden_dim=nerf.sigma_network.n_neurons,
        sigma_hidden_layers=nerf.sigma_network.n_hidden_layers,
        intensity_hidden_dim=nerf.intensity_network.n_neurons,
        intensity_hidden_layers=nerf.intensity_network.n_hidden_layers,
        compute_dtype=nerf.get("compute_dtype", "float32"),
    )


def build_loss_config(loss: Settings) -> LossConfig:
    return LossConfig(
        loss_selection=loss.loss_selection,
        min_js_score=loss.JS_loss.min_js_score,
        max_js_score=loss.JS_loss.max_js_score,
        js_alpha=loss.JS_loss.alpha,
        decay_los_lambda=loss.decay_los_lambda,
        los_lambda=loss.los_lambda,
        min_los_lambda=loss.min_los_lambda,
        los_lambda_decay_rate=loss.los_lambda_decay_rate,
        los_lambda_decay_steps=loss.los_lambda_decay_steps,
        decay_depth_eps=loss.decay_depth_eps,
        depth_eps=loss.depth_eps,
        min_depth_eps=loss.min_depth_eps,
        depth_eps_decay_rate=loss.depth_eps_decay_rate,
        depth_eps_decay_steps=loss.depth_eps_decay_steps,
        depthloss_lambda=loss.depthloss_lambda,
        cam_lambda=loss.cam_lambda,
    )


def build_mapper_config(settings: Settings, world_scale: float) -> MapperConfig:
    opt = settings.mapper.optimizer
    mc = opt.model_config
    return MapperConfig(
        nerf=build_nerf_config(mc.model),
        loss=build_loss_config(mc.loss),
        occ=OccGridConfig(
            voxel_size=mc.model.occ_model.voxel_size,
            lr=mc.model.occ_model.lr,
            n_iters_acc=mc.model.occ_model.N_iters_acc,
            estimator=mc.model.occ_model.get("estimator", "stochastic"),
        ),
        ray_range=tuple(settings.data.ray_range),
        world_scale=world_scale,
        window_size=settings.mapper.keyframe_manager.window_selection.window_size,
        max_keyframes=opt.get("max_keyframes", 512),
        rays_per_kf=opt.num_samples.lidar,
        sky_rays_per_kf=opt.num_samples.sky,
        n_samples_train=mc.model.render.N_samples_train,
        n_samples_test=mc.model.render.N_samples_test,
        perturb=mc.model.render.perturb,
        samples_strategy=opt.samples_selection.strategy,
        rays_strategy=opt.rays_selection.strategy,
        lr_sigma=mc.train.lrate_sigma_mlp,
        lr_rgb=mc.train.lrate_rgb,
        lr_pose=mc.train.lrate_pose,
        lr_gamma=mc.train.lrate_gamma,
        pose_lr_gamma=mc.train.pose_lrate_gamma,
        rgb_weight_decay=mc.train.rgb_weight_decay,
        sigma_weight_decay=mc.train.sigma_weight_decay,
    )


def build_schedule(settings: Settings):
    skip_refine = settings.mapper.optimizer.get("skip_pose_refinement", True)
    phases = []
    for entry in settings.mapper.optimizer.keyframe_schedule:
        its = []
        for it in entry.iteration_schedule:
            phase = IterationPhase(
                num_iterations=it.num_iterations,
                freeze_poses=it.get("freeze_poses", False),
                freeze_sigma_mlp=it.get("freeze_sigma_mlp", False),
                freeze_rgb_mlp=it.get("freeze_rgb_mlp", True),
                latest_kf_only=it.get("latest_kf_only", False),
            )
            if skip_refine and phase.latest_kf_only:
                continue  # skip_pose_refinement
            its.append(phase)
        phases.append(SchedulePhase(entry.num_keyframes, its))
    return phases


def build_keyframe_manager_config(settings: Settings) -> KeyFrameManagerConfig:
    km = settings.mapper.keyframe_manager
    return KeyFrameManagerConfig(
        selection_strategy=km.keyframe_selection.strategy,
        time_diff_seconds=km.keyframe_selection.temporal.time_diff_seconds,
        translation_threshold_m=km.keyframe_selection.motion.translation_threshold_m,
        rotation_threshold_deg=km.keyframe_selection.motion.rotation_threshold_deg,
        window_selection=km.window_selection.strategy,
        window_size=km.window_selection.window_size,
        num_recent_frames=km.window_selection.hybrid_settings.num_recent_frames,
    )


def build_tracker_config(settings: Settings) -> TrackerConfig:
    icp = settings.tracker.icp
    return TrackerConfig(
        icp=IcpConfig(stages=tuple(IcpStage(threshold=st.threshold, max_iterations=st.max_iterations)
                                   for st in icp.schedule)),
        scan_duration=icp.scan_duration,
        target_points=icp.downsample.target_uniform_point_count,
        motion_compensation=settings.tracker.motion_compensation.enabled,
        sky_segmentation=settings.system.get("sky_segmentation", False),
    )


def build_loop_closure_config(settings: Settings) -> LoopClosureConfig:
    lc = settings.system.get("loop_closure", None)
    if lc is None:
        return LoopClosureConfig()
    return LoopClosureConfig(
        enabled=lc.get("enabled", False),
        min_index_gap=lc.get("min_index_gap", 8),
        max_candidate_distance_m=lc.get("max_candidate_distance_m", 4.0),
    )


def build_debug_flags(settings: Settings) -> DebugFlags:
    """The ``debug:`` block's dump flags; ``dump_dir`` stays None (LonerSLAM
    points it at <out_dir>/debug)."""
    flags = settings.debug.get("flags", Settings())
    return DebugFlags(
        global_enabled=settings.debug.get("global_enabled", False),
        draw_icp_clouds=flags.get("draw_icp_clouds", False),
        draw_rays=flags.get("draw_rays", False),
        draw_samples=flags.get("draw_samples", False),
        draw_loss_distribution=flags.get("draw_loss_distribution", False),
    )


def build_slam_config(settings: Settings, world_scale: float) -> SlamConfig:
    return SlamConfig(
        tracker=build_tracker_config(settings),
        frame_synthesis=FrameSynthesisConfig(
            frame_decimation_rate_hz=settings.tracker.frame_synthesis.frame_decimation_rate_hz,
            decimate_on_load=settings.tracker.frame_synthesis.decimate_on_load,
        ),
        mapper=OnlineMapperConfig(
            mapper=build_mapper_config(settings, world_scale),
            keyframe_manager=build_keyframe_manager_config(settings),
            schedule=build_schedule(settings),
            n_sky_pad=settings.data.get("sky_points_budget", 4096),
            log_level=settings.mapper.get("log_level", "STANDARD"),
            log_losses=settings.debug.global_enabled and settings.debug.flags.get("log_losses", False),
            debug=build_debug_flags(settings),
        ),
        single_threaded=settings.system.single_threaded,
        max_time_delta=settings.system.synchronization.max_time_delta,
        use_groundtruth_poses=settings.debug.flags.get("use_groundtruth_poses", False),
        loop_closure=build_loop_closure_config(settings),
    )
