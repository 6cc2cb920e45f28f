from .harness import (NodeStats, benchmark_plan, describe_plan, format_stats,
                      plan_children,
                      save_dot, to_dot)
