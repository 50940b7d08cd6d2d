"""Cross-validation: leave-one-out, leave-some-out, new data, and the component selector."""
