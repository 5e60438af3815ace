"""Multi-LoRA algebra, the flow planner, the forward step and the
virtualized adapter store."""
