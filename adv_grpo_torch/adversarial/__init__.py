"""See adv_grpo_torch/__init__.py."""
