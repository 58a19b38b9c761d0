"""Models the port supports: LeNet and logistic regression."""
