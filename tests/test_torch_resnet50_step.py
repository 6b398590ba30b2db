"""One stage-1 train step of the port at ResNet-50 against the JAX
package's, by check_step_matches_jax's ResNet-50 rule (its docstring says
why that rule): EMBED_DIM 64, B=2, every gradient tensor held.

The proxy is 36^2, the smallest size at which the port's train-mode
float32 forward at ResNet-50 is within 1e-3 of its float64 forward (2.5e-4;
at 32^2 layer4 normalises one value a sample and the forward is chaotic,
0.78). Each stage takes ~110 s on the CPU, so the two stages are two files,
which the suite's workers take in parallel.
"""

from test_torch_train_step import check_step_matches_jax, make_batch

SIZE = 36


def test_stage1_train_step_matches_jax_at_resnet50():
    check_step_matches_jax(make_batch(SIZE), 1, layers=50, size=SIZE,
                           resnet50_rule=True)
