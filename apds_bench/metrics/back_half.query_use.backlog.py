"""The back half's useful queries, %: the live keypoints of the frames it
yielded over the query slots it matched (each batch's rows, padded ones
included, times the features' slots; StageTimes counts)."""

from apds_bench.metrics._spans import query_use as read  # noqa: F401
