"""region.cluster_s (s a pass; layer: incubator): the main thread's strand
loop of each region: the immediate sets merged, BundleGroup.resolve
(cross-sample clustering), the Assemblers built (the span region.cluster,
meta/incubator.py), the mean over the window's passes."""

from bmk.spans import span_s

read = span_s("region.cluster")
