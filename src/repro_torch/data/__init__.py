from .regression import REGRESSION_DATASETS, RegressionSpec, make_regression, \
    make_regression_dataset
from .tokens import synthetic_lm_batch, token_stream
