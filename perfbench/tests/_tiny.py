"""A cell at a size the CPU runs in seconds: few vertices, faces and
frames, 20 iterations per stage; every width of the configuration
otherwise kept."""

TINY = {"config": {"model": {"num_verts": 1000, "num_faces": 1950},
                   "preset": {"lbfgs_iters_per_stage": 20, "max_evals": 30}},
        "traffic": {"frames_per_fit": 2, "fit_pool": 2, "check_frames": 4,
                    "warmup_iters": 1}}
CELL = "combined-b128"
