from .numeric import assert_bitwise_equal, calc_diff, to_numpy
