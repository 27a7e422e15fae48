"""The share of the window's steps' extent in which the device ran no
step of the stream, waiting on the host, %: 1 - the union of the `step`
spans over the time from the first step start to the last step end (gaps
inside a graph replay count as busy; none off the card)."""

from apds_bench.metrics._spans import starved_share as read  # noqa: F401
