from exposure_jax.models.networks import CriticNet, FeatureExtractor, PolicyNet
from exposure_jax.models.agent import (
    AgentStepOutput,
    agent_step,
    enrich_image_input,
    initial_states,
)
