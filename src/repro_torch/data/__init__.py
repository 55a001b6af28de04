"""Problem data for the port: Table 3 stand-ins, Sec. A.14's synthetic
generator, LibSVM text parsing and the oracle dict."""

from .libsvm import parse_libsvm, partition_across_silos
from .problems import make_problem, problem_from_data
from .synthetic import LIBSVM_SHAPES, make_iid, make_libsvm_like, make_synthetic
