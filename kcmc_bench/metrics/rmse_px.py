"""rmse_px: the last call's registration error over every frame it
corrected against the generator's ground truth (transform RMSE on the
9x9 control grid, or field RMSE; the configuration says which)."""


def read(run):
    return run.rmse_px
