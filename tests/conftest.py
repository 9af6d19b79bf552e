"""Test env: force an 8-device virtual CPU mesh before JAX initializes, so
sharding/collective tests run without accelerator hardware (SURVEY.md §4)."""

import os

# Tests run on the CPU: it leaves any accelerator free and gives fp32-exact
# math.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# jax.config wins over any platform an installed plug-in pins.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


# ---- test tiers ------------------------------------------------------------
# `-m unit` is the pre-commit gate (<3 min): everything NOT in the
# integration list below. The list holds the end-to-end fits and other
# >~8 s tests (measured full-suite durations, docs in README.md). New
# slow tests: add them here or mark them @pytest.mark.integration.

_INTEGRATION = {
    "test_blocknerf_train_and_playback",
    "test_viewer_nerf_extras",
    "test_batched_matches_global",
    "test_brdf_shading_properties",
    "test_build_nerf_network_from_reference_config",
    "test_dp_grid_update",
    "test_dp_step_matches_replicated_semantics",
    "test_engine_init_grid_with_prior",
    "test_eval_test_transforms_self",
    "test_fsdp_step_matches_single_chip",
    "test_grid_gather_blend_backward_matches_scatter_add",
    "test_hashgrid_bf16_gather_matches_f32",
    "test_hashgrid_grad_scatter",
    "test_lattice_march_matches_sequential",
    "test_march_more_slots_than_lattice",
    "test_occupied_at_lookup",
    "test_pair_gather_boundary_exact",
    "test_params_round_trip_and_output_parity",
    "test_pixel_stride_registration",
    "test_render_encoding_vis",
    "test_sample_update_cells_shapes_and_bias",
    "test_simplex_gradients_flow",
    "test_simplex_training_step_runs",
    "test_takikawa_encoding_forward_and_zeros",
    "test_takikawa_matches_bruteforce",
    "test_takikawa_sum_mode",
    "test_takikawa_table_gradient",
    "test_testbed_image_roundtrip",
    "test_trainer_fits_toy_regression",
    "test_training_data_generation",
    "test_training_loss_grads_match_reference_formula",
    "test_training_sample_recipe",
    "test_update_grid_state_smoke",
    "test_golden_render_and_gradients",
    "test_build_image_network_from_reference_config",
    "test_camera_refinement_recovers_pose_noise",
    "test_cli_sdf_end_to_end",
    "test_density_slice",
    "test_depth_supervision_trains_and_matches_gt_depth",
    "test_distortion_map_recovers_lens_offset",
    "test_dp_step_equivalent_to_single_chip_math",
    "test_dp_training_converges_and_renders",
    "test_dup_backward_corners_matches_pairs",
    "test_engine_hook",
    "test_engine_reference_snapshot_round_trip",
    "test_envmap_learns_synthetic_sky",
    "test_extra_learnable_dims",
    "test_foveated_render_close_to_full_at_focus",
    "test_graft_entry_points",
    "test_image_fit_albert_downscaled",
    "test_overlays",
    "test_pair_gather_matches_classic_path",
    "test_ray_file_loading_and_training",
    "test_render_crop_box",
    "test_render_modes",
    "test_render_view_dof",
    "test_render_view_shape_and_spp",
    "test_render_with_shutter",
    "test_rolling_shutter_smoke_and_motion_blur_xform_use",
    "test_sdf_engine_mesh_export",
    "test_sdf_engine_with_takikawa_and_octree",
    "test_sdf_fit_cube",
    "test_sdf_render_modes_and_shadows",
    "test_set_image",
    "test_train_loop_meters_and_snapshot_loss_ema",
    "test_train_sphere_to_psnr",
    "test_two_process_dp_step",
    "test_volume_fit",
    "test_hierarchical_march_matches_ungated",
    "test_winding_sign_robust_to_holes",
    "test_sdf_engine_sign_mode_winding",
    "test_engine_grid_strides_rounded_to_pow2",
    "test_training_rays_route_all_lens_modes",
    "test_staged_render_matches_single_pass",

}


def pytest_collection_modifyitems(config, items):
    import pytest

    for item in items:
        base = item.name.split("[")[0]
        if base in _INTEGRATION or item.get_closest_marker("slow"):
            item.add_marker(pytest.mark.integration)
        else:
            item.add_marker(pytest.mark.unit)
