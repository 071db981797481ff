"""Command-line tools of the port: the task evaluation (make_eval), its
per-step traversal telemetry (debug_traversal) and the distillation of
policies into gait-prior clips (distill_prior)."""
