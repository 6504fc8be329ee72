from .regression import REGRESSION_DATASETS, RegressionSpec, make_regression, \
    make_regression_dataset
