"""Problem data for the port: Table 3 stand-ins and the oracle dict."""

from .problems import make_problem, problem_from_data
from .synthetic import LIBSVM_SHAPES, make_libsvm_like
