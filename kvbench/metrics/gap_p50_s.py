"""``tbt_p50_s`` read per layer, for the cells where it is too unsteady
from run to run to stand end to end: the median of every gap between
consecutive tokens of a request that ends inside the window."""
from kvbench.bench import metric_reader

read = metric_reader("tbt_p50_s").read
