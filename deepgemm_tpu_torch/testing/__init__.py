from .bench import bench_kernel, bench_profiled
from .numeric import assert_bitwise_equal, calc_diff, count_bytes, to_numpy
from .utils import get_arch_major, get_device_core_count, test_filter
